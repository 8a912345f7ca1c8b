"""The ZeRO-3 gather window: the port's form of the reference's promise
that "replicated params only materialize for the live window of buckets"
(:mod:`tony_tpu.parallel.sched`, ``GatherPlan.window_nbytes``).

:class:`GatherWindow` drives one step's gathers and reduces over the
module that owns the parameters, through hooks it installs for the step
and removes after it:

* **Forward.** Each scatter bucket of the
  :class:`~tony_tpu_torch.parallel.sched.GatherPlan` is gathered just
  before the first module that reads its leaves runs (a forward pre-hook
  on every module that owns a gathered leaf), at most ``prefetch``
  buckets ahead in consumption order (all of them at once with
  ``prefetch=0``, as in the reference). A bucket is freed once a module
  whose leaves all lie past it starts, so a bucket that straddles modules
  stays live from its first reader to its last.
* **Backward.** A bucket is gathered again, in reverse order with the
  same prefetch, just before its readers' backward: when the grad of a
  reader's output is ready (a tensor hook), and when a checkpointed
  block recomputes its forward (the pre-hook fires again; a bucket
  already gathered is neither gathered nor counted twice). It is freed
  once every leaf of it has its grad.
* **Reads outside module hooks.** A leaf owned by the root module (the
  decoder's embedding) or by a module whose forward does not run (the
  head under ``xent_chunk``, whose weight the root reads) is gathered by
  consumption order like any other: the root's pre-hook gathers the
  root's own buckets, and after each reader's forward the next bucket in
  order is made ready, so a read between two hooks finds it. For the
  backward, the buckets of such leaves that lie past the last reader are
  gathered when the grad of the root's output is ready, and those before
  the first reader when the grad of the first reader's input is.
* **Reduce as grads land.** A post-accumulate-grad hook on every leaf
  counts the bucket's grads; when the last one lands, the bucket is
  packed and its reduce (``reduce_scatter`` over fsdp and the data-axis
  ``all_reduce``, or the replicated buckets' reduce) is issued at once,
  and the whole grads are dropped. A leaf that got no grad counts as
  zeros, once the backward is done.

The gathered bits are the shards' bits, so the step is bitwise the
gather-everything step (``gather="per_leaf"``).

**Saved tensors.** Each gathered leaf gets one whole tensor for the step,
which the parameter's ``.data`` points at during a microbatch. Freeing
resizes its storage to 0 bytes; gathering resizes it back and writes the
gathered bits into it. Autograd saved the parameter (or a view of it),
which shares that storage, so the backward reads the re-gathered bits:
the flat-parameter trick of PyTorch's FSDP. A buffer a collective still
writes is waited for before it is freed.

**What may be live.** :meth:`GatherWindow.bound_nbytes` is the most
gathered bytes these rules allow at once: for each reader (a module that
owns gathered leaves; with remat, each checkpointed block, whose
recompute needs all of its buckets together) the buckets its leaves span
plus ``prefetch`` more on the side the walk is heading. It exceeds
:meth:`~tony_tpu_torch.parallel.sched.GatherPlan.window_nbytes` (the
``prefetch + 1`` largest consecutive buckets) only where a reader's
leaves span more than one bucket; :meth:`GatherWindow.allowance_nbytes`
is the excess. The step records its high-water mark beside both.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import torch
from torch import nn

IDLE, ISSUED, READY = 0, 1, 2
FWD, BWD = "forward", "backward"


def _empty_like_shape(shape: Tuple[int, ...], dtype: Any,
                      device: torch.device) -> torch.Tensor:
    """A contiguous tensor of ``shape`` over a storage of 0 bytes. (``set_``
    onto an empty storage would size the storage to the shape, so the
    tensor is made whole and its storage freed at once.)"""
    t = torch.empty(shape, dtype=dtype, device=device)
    t.untyped_storage().resize_(0)
    return t


def remat_units(module: nn.Module) -> List[nn.Module]:
    """The blocks a checkpointed forward recomputes as one unit in the
    backward: a decoder's layers when its config remats, else none."""
    cfg = getattr(module, "cfg", None)
    layers = getattr(module, "layers", None)
    if getattr(cfg, "remat", False) and isinstance(layers, nn.ModuleList):
        return list(layers)
    return []


class GatherWindow:
    """One step's gather window and reduce-on-ready over ``module``.

    ``params`` is ``list(module.parameters())`` (the plan's leaf order),
    ``gplan`` the step's GatherPlan over ``plan``, ``group`` the fsdp
    process group. ``bufs`` are the ShardBuckets' local buffers (each
    gather sends its bucket's as it is), ``scales`` the quantized lane's
    shared scales, one per gather bucket. ``reduce(b, grads)`` issues
    plan bucket ``b``'s reduce from its leaves' grads (None for a leaf
    that got none) and ``drain()`` completes every reduce issued.

    Use as a context manager around the microbatch loop; per microbatch
    :meth:`begin`, run the forward, :meth:`backward` around
    ``loss.backward()``, then :meth:`end` (in a ``finally``)."""

    def __init__(self, module: nn.Module, params: Sequence[torch.Tensor],
                 plan: Any, gplan: Any, group: Any, *,
                 reduce: Callable[[int, List[Optional[torch.Tensor]]], None],
                 drain: Callable[[], None],
                 bufs: Optional[Sequence[Optional[torch.Tensor]]] = None,
                 scales: Optional[Sequence[torch.Tensor]] = None):
        self.module, self.params = module, list(params)
        self.plan, self.gplan, self.group = plan, gplan, group
        self.bufs, self.scales = bufs, scales
        self._reduce, self._drain = reduce, drain
        self.prefetch = gplan.prefetch
        self.K = gplan.n_gather_buckets
        self.k_of_bucket = {b: k for k, b in enumerate(gplan.gather_buckets)}
        self.b_of_leaf = {i: b for b, idxs in enumerate(plan.buckets)
                          for i in idxs}
        self.k_of_leaf = {i: self.k_of_bucket[b]
                          for i, b in self.b_of_leaf.items()
                          if b in self.k_of_bucket}
        index = {id(p): i for i, p in enumerate(self.params)}
        # Readers: the modules owning gathered leaves directly, with the
        # gather buckets of those leaves; the root is kept apart.
        self.readers: Dict[nn.Module, Tuple[int, ...]] = {}
        self.owners: Dict[int, List[nn.Module]] = {}
        self.root_ks: Tuple[int, ...] = ()
        for m in module.modules():
            leaves = [index[id(p)] for p in m._parameters.values()
                      if p is not None and id(p) in index]
            for i in leaves:
                self.owners.setdefault(i, []).append(m)
            ks = tuple(sorted({self.k_of_leaf[i] for i in leaves
                               if i in self.k_of_leaf}))
            if not ks:
                continue
            if m is module:
                self.root_ks = ks
            else:
                self.readers[m] = ks
        self.whole: Dict[int, torch.Tensor] = {}
        self.state = [IDLE] * self.K
        self.pending: List[Any] = [None] * self.K
        self.hooks: List[Any] = []
        self.phase: Optional[str] = None
        self.reduces = [0] * plan.n_buckets
        self.stats: Dict[str, Any] = {}

    # -- set-up and tear-down ------------------------------------------

    def __enter__(self) -> "GatherWindow":
        plan, dev = self.plan, self.params[0].device
        for k, b in enumerate(self.gplan.gather_buckets):
            for i in plan.buckets[b]:
                self.whole[i] = _empty_like_shape(plan.shapes[i],
                                                  plan.dtypes[i], dev)
        try:
            for m in self.readers:
                self.hooks.append(m.register_forward_pre_hook(self._pre))
                self.hooks.append(m.register_forward_hook(self._post))
            self.hooks.append(self.module.register_forward_pre_hook(
                self._root_pre))
            self.hooks.append(self.module.register_forward_hook(
                self._root_post))
            for i, p in enumerate(self.params):
                if p.requires_grad:
                    self.hooks.append(p.register_post_accumulate_grad_hook(
                        lambda _p, i=i: self._landed(i)))
        except BaseException:
            self._remove()
            raise
        return self

    def __exit__(self, *exc) -> None:
        self._remove()
        self.whole.clear()

    def _remove(self) -> None:
        for h in self.hooks:
            h.remove()
        self.hooks.clear()

    def begin(self) -> None:
        """A microbatch starts: no parameter holds a grad, and every
        gathered leaf's ``.data`` is its (freed) whole tensor until
        :meth:`end`."""
        for p in self.params:
            p.grad = None
        held = sum(w.untyped_storage().nbytes() for w in self.whole.values())
        if held:
            raise RuntimeError(f"the gather window starts a microbatch with "
                               f"{held} bytes of whole parameters held")
        self.local = {i: self.params[i].data for i in self.whole}
        self.local_list = [self.local.get(i, p.data)
                           for i, p in enumerate(self.params)]
        for i, w in self.whole.items():
            self.params[i].data = w
        self.phase = FWD
        self.fired: Set[nn.Module] = set()
        self.head: Tuple[int, ...] = ()
        self.tail: Tuple[int, ...] = ()
        self.head_hooked = False
        self.done = [False] * self.K
        self.landed: Set[int] = set()
        self.counts = [0] * self.plan.n_buckets
        self.reduced = [False] * self.plan.n_buckets
        self.first_reduce: Optional[List[int]] = None
        self.gplan.live.issued = []
        self.n_fwd = 0

    def backward(self) -> None:
        """The loss's backward is about to run."""
        self.n_fwd = len(self.gplan.live.issued)
        self.phase = BWD

    def finish_backward(self) -> None:
        """The backward is done: reduce every bucket still waiting (a leaf
        that got no grad counts as zeros), complete the reduces, free
        what is gathered, and check that every bucket was reduced exactly
        once."""
        for b in range(self.plan.n_buckets):
            if not self.reduced[b]:
                self._bucket_done(b)
        self._drain()
        for k in range(self.K):
            self._release(k)
        if not all(self.reduced):
            raise RuntimeError("a bucket was not reduced this microbatch")
        issued = self.gplan.live.issued
        self.stats = {
            "fwd_gathers": self.n_fwd,
            "bwd_gathers": len(issued) - self.n_fwd,
            "gathered_wire_nbytes": list(issued),
            "first_reduce_landed": self.first_reduce or [],
        }

    def end(self) -> None:
        """The microbatch is over (or raised): free everything gathered
        (waiting for any gather in flight first), put every parameter
        back on its shard and drop any grad left."""
        self.phase = None
        try:
            for k in range(self.K):
                self._release(k)
        finally:
            for i, t in getattr(self, "local", {}).items():
                self.params[i].data = t
            for p in self.params:
                p.grad = None
            self.local, self.local_list = {}, []

    # -- the bucket state machine ---------------------------------------

    def _direct(self, b: int) -> bool:
        """Whether bucket ``b``'s gathered buffer is its one leaf's whole
        tensor as it lies (one leaf sharded on dim 0, unquantized)."""
        idxs = self.plan.buckets[b]
        return len(idxs) == 1 and self.plan.shard_dims[idxs[0]] == 0 \
            and self.scales is None

    def _issue(self, k: int) -> None:
        if self.state[k] != IDLE:
            return
        b = self.gplan.gather_buckets[k]
        out = None
        if self._direct(b):
            w = self.whole[self.plan.buckets[b][0]]
            w.untyped_storage().resize_(w.numel() * w.element_size())
            out = w.view(-1)
        self.pending[k] = self.gplan.issue(
            k, self.gplan.chunk(k, self.local_list, self.bufs),
            self.group, scale=None if self.scales is None
            else self.scales[k], out=out)
        self.state[k] = ISSUED

    @torch.no_grad()
    def _ready(self, k: int) -> None:
        """Gather bucket ``k`` (if it is not in flight yet) and wait for
        it; its whole leaves then hold the gathered bits."""
        if self.state[k] == READY:
            return
        self._issue(k)
        b = self.gplan.gather_buckets[k]
        full = self.gplan.finish(self.pending[k])
        self.pending[k] = None
        if not self._direct(b):
            _unpack_gathered(self.plan, b, full, self.whole)
        del full
        self.state[k] = READY

    @torch.no_grad()
    def _release(self, k: int) -> None:
        if self.state[k] == IDLE:
            return
        if self.state[k] == ISSUED:
            self.pending[k].work.wait()
            self.pending[k] = None
        for i in self.plan.buckets[self.gplan.gather_buckets[k]]:
            self.whole[i].untyped_storage().resize_(0)
        self.gplan.release(k)
        self.state[k] = IDLE

    # -- forward --------------------------------------------------------

    def _prefetch_fwd(self, hi: int) -> None:
        last = self.K if not self.prefetch else min(self.K,
                                                    hi + 1 + self.prefetch)
        for k in range(hi + 1, last):
            self._issue(k)

    def _root_pre(self, module: nn.Module, args: Any) -> None:
        if self.phase != FWD:
            return
        for k in self.root_ks:
            self._ready(k)
        self._prefetch_fwd(max(self.root_ks, default=-1))

    def _pre(self, module: nn.Module, args: Any) -> None:
        ks = self.readers[module]
        if self.phase == FWD:
            if not self.fired:
                self._hook_head(args)
            self.fired.add(module)
            for k in range(ks[0]):
                self._release(k)
            for k in ks:
                self._ready(k)
            self._prefetch_fwd(ks[-1])
        elif self.phase == BWD:
            # A checkpointed block recomputes its forward.
            for k in ks:
                self._ready(k)

    def _post(self, module: nn.Module, args: Any, out: Any) -> None:
        if self.phase != FWD:
            return
        nxt = self.readers[module][-1] + 1
        if nxt < self.K:
            self._ready(nxt)
        _hook_outputs(out, lambda: self._bwd_reader(module))

    def _root_post(self, module: nn.Module, args: Any, out: Any) -> None:
        if self.phase != FWD:
            return
        # Stray reads: the root's own leaves and those of modules whose
        # forward did not run, which the root read itself.
        first = min((self.readers[m][0] for m in self.fired),
                    default=self.K)
        stray = set(self.root_ks)
        for i, k in self.k_of_leaf.items():
            if not any(m in self.fired for m in self.owners.get(i, [])):
                stray.add(k)
        self.head = tuple(sorted(k for k in stray if k < first))
        self.tail = tuple(sorted(k for k in stray if k >= first))
        if not self.head_hooked:
            self.tail = tuple(sorted(set(self.tail) | set(self.head)))
            self.head = ()
        for k in range(self.K):
            self._release(k)
        _hook_outputs(out, self._bwd_root)

    def _hook_head(self, args: Any) -> None:
        """The first reader's inputs: their grads are ready just before
        the backward of whatever the root read ahead of it."""
        self.head_hooked = _hook_outputs(args, self._bwd_head)

    # -- backward -------------------------------------------------------

    def _prefetch_bwd(self, lo: int) -> None:
        first = -1 if not self.prefetch else max(-1, lo - 1 - self.prefetch)
        for k in range(lo - 1, first, -1):
            if not self.done[k]:
                self._issue(k)

    def _bwd_root(self) -> None:
        if self.phase != BWD:
            return
        for k in reversed(self.tail):
            self._ready(k)
        self._prefetch_bwd(self.tail[0] if self.tail else self.K)

    def _bwd_reader(self, module: nn.Module) -> None:
        if self.phase != BWD:
            return
        ks = self.readers[module]
        for k in reversed(ks):
            self._ready(k)
        self._prefetch_bwd(ks[0])

    def _bwd_head(self) -> None:
        if self.phase != BWD:
            return
        for k in reversed(self.head):
            self._ready(k)

    def _landed(self, i: int) -> None:
        if self.phase != BWD or i in self.landed:
            return
        self.landed.add(i)
        b = self.b_of_leaf[i]
        self.counts[b] += 1
        if self.counts[b] == len(self.plan.buckets[b]):
            self._bucket_done(b)

    def _bucket_done(self, b: int) -> None:
        if self.first_reduce is None:
            self.first_reduce = sorted(self.landed)
        idxs = self.plan.buckets[b]
        grads = [self.params[i].grad for i in idxs]
        self._reduce(b, grads)
        del grads
        for i in idxs:
            self.params[i].grad = None
        self.reduced[b] = True
        self.reduces[b] += 1
        k = self.k_of_bucket.get(b)
        if k is not None:
            self.done[k] = True
            self._release(k)

    # -- the bound ------------------------------------------------------

    def _span_nbytes(self, lo: int, hi: int) -> int:
        sizes = self.gplan.gather_nbytes
        return sum(sizes[max(lo, 0):min(hi, self.K - 1) + 1])

    def bound_nbytes(self) -> int:
        """The most gathered bytes the window's rules allow at once (see
        the module's docstring)."""
        if not self.K:
            return 0
        if not self.prefetch:
            return sum(self.gplan.gather_nbytes)
        units = [tuple(self.readers[m] for m in unit.modules()
                       if m in self.readers) for unit in
                 remat_units(self.module)]
        spans = [(ks[0], ks[-1]) for ks in self.readers.values()]
        spans += [(min(k[0] for k in u), max(k[-1] for k in u))
                  for u in units if u]
        spans.append((min(self.root_ks, default=0),
                       max(self.root_ks, default=0)))
        p = self.prefetch
        return max(max(self._span_nbytes(lo, hi + p),
                       self._span_nbytes(lo - p, hi))
                   for lo, hi in spans)

    def allowance_nbytes(self) -> int:
        """What :meth:`bound_nbytes` adds over ``window_nbytes()``: the
        buckets a reader's (or a recomputed block's) leaves span beyond
        one."""
        return max(0, self.bound_nbytes() - self.gplan.window_nbytes())


def _hook_outputs(out: Any, fn: Callable[[], None]) -> bool:
    """Register ``fn`` (called with no argument, the grad untouched) on
    every tensor in ``out`` that takes part in autograd; returns whether
    any did."""
    found = False
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.requires_grad:
                x.register_hook(lambda g: fn())
                found = True
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return found


def _unpack_gathered(plan: Any, b: int, full: torch.Tensor,
                     whole: Dict[int, torch.Tensor]) -> None:
    """Bucket ``b``'s gathered (shard-major) buffer into its leaves' whole
    tensors, whose storages are sized first: the bits of
    ``plan.leaf_buffers(b, full, layout="gathered")``, written in
    place."""
    chunk = plan.bucket_numel[b] // plan.shard_size
    off = 0
    for i in plan.buckets[b]:
        shp = plan.shard_shape(i)
        n = math.prod(shp)
        w = whole[i]
        w.untyped_storage().resize_(w.numel() * w.element_size())
        torch.cat([full[f * chunk + off:f * chunk + off + n].view(shp)
                   for f in range(plan.shard_size)],
                  dim=plan.shard_dims[i], out=w)
        off += n

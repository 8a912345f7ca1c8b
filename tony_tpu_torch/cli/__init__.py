"""``tony-torch`` command-line interface (layer L6): the port's copy of the
part of :mod:`tony_tpu.cli` that submits, serves and manages jobs.

Mirrors ``tony-cli``'s ``ClusterSubmitter`` (upstream ``tony-cli/src/main/
java/com/linkedin/tony/cli/ClusterSubmitter.java``, unverified — SURVEY.md
§0/§2.2) plus the client flag surface of ``TonyClient#init``; the flags keep
the reference's names::

    python -m tony_tpu_torch.cli submit --src_dir src/ --executes train.py \\
        --framework pytorch --conf tony.worker.instances=2 \\
        --conf tony.worker.gpus=1

Subcommands:

* ``submit``  — submit a job and monitor it to completion (exit code = job's)
* ``serve``   — submit a serving job of the port's replica
  (``python -m tony_tpu_torch.serve.replica``); ``--gpus`` pins each
  replica's cards; ``--role prefill=N,decode=M`` splits the fleet into
  a prefill and a decode jobtype (disaggregated serving)
* ``route``   — run the fleet's request router
  (:mod:`tony_tpu_torch.serve.router`) against a live job's AM
* ``kill``    — kill a running job
* ``logs``    — print per-container logs of a local-substrate job
* ``version`` — print the version

Not in the port yet (ROADMAP queue 1, item 10): ``publish``, ``aot``,
``history``, ``notebook``, ``azkaban``, ``profile``, ``resize`` and
``analyze``. Standard library only.
"""

from __future__ import annotations

import argparse
import json
from collections import deque
from pathlib import Path
from typing import List, Optional

from tony_tpu_torch import conf as conf_mod
from tony_tpu_torch import constants
from tony_tpu_torch.conf import TonyConfig
from tony_tpu_torch.util import default_workdir

__version__ = "0.3.0"

REPLICA_COMMAND = "python -m tony_tpu_torch.serve.replica"
_ITEM = "ROADMAP.md, queue 1 item {}"


def _parse_conf_overrides(pairs: List[str]) -> dict:
    out = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"--conf expects key=value, got {pair!r}")
        k, _, v = pair.partition("=")
        out[k.strip()] = v.strip()
    return out


def build_conf(args: argparse.Namespace) -> TonyConfig:
    """Effective config from file + CLI switches + ``--conf`` overrides —
    the reference's layering (SURVEY.md §5.6), highest precedence last."""
    cfg = TonyConfig()
    if args.conf_file:
        cfg.merge_file(args.conf_file)
    if getattr(args, "executes", None):
        cfg.set("tony.application.executes", args.executes)
    if getattr(args, "framework", None):
        cfg.set(conf_mod.APPLICATION_FRAMEWORK, args.framework)
    if getattr(args, "name", None):
        cfg.set(conf_mod.APPLICATION_NAME, args.name)
    if getattr(args, "python_venv", None):
        cfg.set(conf_mod.PYTHON_VENV, args.python_venv)
    if getattr(args, "python_binary_path", None):
        cfg.set(conf_mod.PYTHON_BINARY, args.python_binary_path)
    cfg.merge_overrides(_parse_conf_overrides(args.conf or []))
    return cfg


def cmd_submit(args: argparse.Namespace) -> int:
    from tony_tpu_torch.client import TonyClient
    cfg = build_conf(args)
    client = TonyClient(cfg, src_dir=args.src_dir, workdir=args.workdir,
                        am_host=args.am_host, quiet=args.quiet)
    return client.run(timeout=args.timeout)


def _refuse(flag: str, item: int, what: str) -> None:
    raise SystemExit(f"{flag}: {what} is not in the port yet "
                     f"({_ITEM.format(item)})")


def serve_conf(args: argparse.Namespace) -> TonyConfig:
    """The serve job's conf, as the reference's ``cmd_serve`` writes it for
    the same arguments, with the port's replica as the command and
    ``--gpus`` as ``tony.<jobtype>.gpus`` of each serving jobtype. The
    lanes the port's replica does not serve are refused here, at submit,
    naming their ROADMAP item."""
    for flag, val, item, what in (
            ("--mesh", args.mesh, 8, "a replica mesh"),
            ("--follow", args.follow, 10, "follow mode (the fleet swap)")):
        if val:
            _refuse(flag, item, what)
    if args.gpus < 0:
        raise SystemExit(f"--gpus must be >= 0, got {args.gpus}")
    cfg = TonyConfig()
    if args.conf_file:
        cfg.merge_file(args.conf_file)
    # Replicas are independent processes — no rendezvous gang — so the
    # framework is "standalone"; and a serving fleet should outlive one
    # crashed replica, so fail-fast is off.
    cfg.set(conf_mod.APPLICATION_FRAMEWORK, "standalone")
    cfg.set(conf_mod.APPLICATION_NAME,
            args.name or f"tony-serve-{args.model}")
    cfg.set(conf_mod.APPLICATION_STOP_ON_FAILURE, "false")
    # Disaggregated split (--role prefill=2,decode=4): each role becomes
    # its OWN jobtype sharing the serve.* engine config; the per-jobtype
    # role key tells each replica which half of the handoff it fronts.
    # Validated at submit: a mistyped role silently served as a
    # colocated gang would serve the wrong topology.
    roles = _parse_roles(args.role) if args.role else \
        {constants.SERVE: args.replicas}
    for name, n in roles.items():
        cfg.set(conf_mod.instances_key(name), str(n))
        cfg.set(conf_mod.command_key(name), REPLICA_COMMAND)
        if args.role:
            cfg.set(conf_mod.serve_role_key(name), name)
        if args.gpus:
            cfg.set(conf_mod.gpus_key(name), str(args.gpus))
    cfg.set(conf_mod.SERVE_MODEL, args.model)
    if args.model_kwargs:
        json.loads(args.model_kwargs)       # validate at submit, not launch
        cfg.set(conf_mod.SERVE_MODEL_KWARGS, args.model_kwargs)
    if not args.ckpt_dir:
        raise SystemExit("need --ckpt_dir")
    # Absolute: replicas run with a different cwd.
    cfg.set(conf_mod.SERVE_CKPT_DIR, str(Path(args.ckpt_dir).resolve()))
    cfg.set(conf_mod.SERVE_DTYPE_POLICY, args.dtype_policy)
    cfg.set(conf_mod.SERVE_CTX_MAX, str(args.ctx_max))
    if args.max_replicas is not None:
        cfg.set(conf_mod.SERVE_REPLICAS_MAX, str(args.max_replicas))
    if args.spec_k and not 1 <= args.spec_k <= 15:
        # The replica's row block is q_block=16 and the k+1 verify rows
        # must fit it (SpecEngine enforces the same bound at launch).
        raise SystemExit(f"--spec_k must be in [1, 15] (k+1 verify rows "
                         f"ride the 16-row block), got {args.spec_k}")
    for flag, val in (("--draft_model_kwargs", args.draft_model_kwargs),
                      ("--draft_ckpt_dir", args.draft_ckpt_dir)):
        if val and not args.draft_model:
            raise SystemExit(f"{flag} needs --draft_model (without one "
                             f"the replica runs the n-gram self-draft "
                             f"and the flag would be silently ignored)")
    if args.prefill_chunk and (args.prefill_chunk <= 0
                               or args.prefill_chunk % 16):
        raise SystemExit(f"--prefill_chunk must be a positive multiple "
                         f"of the 16-row block, got {args.prefill_chunk}")
    if args.aot_cache:
        cfg.set(conf_mod.SERVE_AOT_CACHE,
                str(Path(args.aot_cache).resolve()))
    if args.warm_standby < 0:
        raise SystemExit(f"--warm_standby must be >= 0, got "
                         f"{args.warm_standby}")
    if args.warm_standby:
        cfg.set(conf_mod.SERVE_WARM_STANDBY, str(args.warm_standby))
    if args.slo_target_ms:
        try:
            target = float(args.slo_target_ms)
        except ValueError:
            _refuse("--slo_target_ms", 10, "per-tenant SLO targets")
        if target < 0:
            raise SystemExit(f"--slo_target_ms must be >= 0, got {target}")
        if target:
            cfg.set(conf_mod.SERVE_SLO_TARGET_MS, str(target))
    # The KV memory hierarchy and the tenants, validated at submit (the
    # replica would refuse a bad value at launch, replica by replica;
    # the store path is made absolute: replicas run with another cwd).
    if args.host_blocks < 0:
        raise SystemExit(f"--host_blocks must be >= 0, got "
                         f"{args.host_blocks}")
    if args.host_blocks:
        cfg.set(conf_mod.SERVE_HOST_BLOCKS, str(args.host_blocks))
    if args.prefix_store:
        cfg.set(conf_mod.SERVE_PREFIX_STORE,
                str(Path(args.prefix_store).resolve()))
    if not 0.0 <= args.demote_watermark <= 1.0:
        raise SystemExit(f"--demote_watermark must be a pool fraction "
                         f"in [0, 1], got {args.demote_watermark}")
    if args.demote_watermark and not args.host_blocks:
        raise SystemExit("--demote_watermark needs --host_blocks > 0 "
                         "(the daemon demotes into the host tier; "
                         "without one the flag would be silently "
                         "ignored)")
    if args.demote_watermark:
        cfg.set(conf_mod.SERVE_DEMOTE_WATERMARK, str(args.demote_watermark))
    if args.tenants:
        from tony_tpu_torch.serve.qos import parse_tenants

        try:
            parse_tenants(args.tenants)
        except ValueError as e:
            raise SystemExit(f"--tenants: {e}")
        cfg.set(conf_mod.SERVE_QOS_TENANTS, args.tenants)
    if args.qos_max_queue < 0:
        raise SystemExit(f"--qos_max_queue must be >= 0, got "
                         f"{args.qos_max_queue}")
    if args.qos_max_queue:
        if not args.tenants:
            raise SystemExit("--qos_max_queue needs --tenants (the cap "
                             "is per tenant class; without a spec it "
                             "would be silently ignored)")
        cfg.set(conf_mod.SERVE_QOS_MAX_QUEUE, str(args.qos_max_queue))
    if args.prefix_cache:
        cfg.set(conf_mod.SERVE_PREFIX_CACHE, "true")
    if args.prefill_chunk:
        cfg.set(conf_mod.SERVE_PREFILL_CHUNK, str(args.prefill_chunk))
    if args.spec_k:
        cfg.set(conf_mod.SERVE_SPEC_K, str(args.spec_k))
    if args.draft_model:
        if not args.spec_k:
            raise SystemExit("--draft_model needs --spec_k > 0 (the "
                             "draft depth arms the speculative lane)")
        cfg.set(conf_mod.SERVE_DRAFT_MODEL, args.draft_model)
        if args.draft_model_kwargs:
            json.loads(args.draft_model_kwargs)  # validate at submit
            cfg.set(conf_mod.SERVE_DRAFT_MODEL_KWARGS,
                    args.draft_model_kwargs)
        if args.draft_ckpt_dir:
            cfg.set(conf_mod.SERVE_DRAFT_CKPT_DIR,
                    str(Path(args.draft_ckpt_dir).resolve()))
    cfg.merge_overrides(_parse_conf_overrides(args.conf or []))
    return cfg


def _parse_roles(spec: str) -> dict:
    """``--role`` as ``{role: replicas}``, with the reference's
    validation: known roles, no duplicates, counts >= 1, and a prefill
    gang only with a decode gang (and the reverse)."""
    roles = {}
    for part in spec.split(","):
        name, _, count = part.partition("=")
        name = name.strip()
        if name not in ("prefill", "decode", "colocated"):
            raise SystemExit(f"--role: unknown role {name!r} "
                             f"(prefill|decode|colocated)")
        if name in roles:
            raise SystemExit(f"--role: duplicate role {name!r}")
        try:
            n = int(count)
        except ValueError:
            raise SystemExit(f"--role: need {name}=<count>, got "
                             f"{part!r}") from None
        if n < 1:
            raise SystemExit(f"--role: {name} needs >= 1 replica, got {n}")
        roles[name] = n
    if ("prefill" in roles) != ("decode" in roles):
        raise SystemExit("--role: a split fleet needs BOTH a prefill and a "
                         "decode gang (the router falls back to colocated "
                         "only per request, not per topology)")
    return roles


def cmd_serve(args: argparse.Namespace) -> int:
    """Submit an online-serving job: ``--replicas`` replica containers of
    :mod:`tony_tpu_torch.serve.replica`, each restoring the training
    checkpoint (bf16 dtype policy by default) and serving it over the RPC
    wire, with ``--gpus`` cards pinned to each."""
    from tony_tpu_torch.client import TonyClient
    client = TonyClient(serve_conf(args), workdir=args.workdir,
                        am_host=args.am_host, quiet=args.quiet)
    return client.run(timeout=args.timeout)


def cmd_route(args: argparse.Namespace) -> int:
    """Run the fleet's request router (:mod:`tony_tpu_torch.serve.router`):
    an RPC front that polls the AM's ``serve_endpoints`` verb for the
    live replica set and dispatches ``generate`` calls by prefix-cache
    overlap, queue depth and p99, with sticky session affinity, failover
    and the prefill -> decode split of a disaggregated fleet. No tensor
    library: it runs on any gateway host."""
    import threading

    from tony_tpu_torch.serve.router import (RequestRouter, RouterPolicy,
                                             RouterServer)

    policy = RouterPolicy(cache_weight=args.cache_weight,
                          queue_weight=args.queue_weight,
                          p99_weight=args.p99_weight)
    router = RequestRouter(block_size=args.block_size, policy=policy)
    server = RouterServer(router, port=args.port, am_address=args.am,
                          poll_s=args.poll_s)
    server.start()
    print(f"[tony-route] listening on {server.address}, tracking "
          f"replicas via AM {args.am}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


def _job_dir_of(args: argparse.Namespace) -> Path:
    workdir = Path(args.workdir) if args.workdir else default_workdir()
    return (workdir / args.app_id).resolve()


def _live_am(args: argparse.Namespace):
    """(job_dir, am_address, token) of a RUNNING job, or None (reported)
    — the shared resolution for every verb that dials a live AM."""
    from tony_tpu_torch.am import AM_ADDRESS_FILE, AM_TOKEN_FILE

    job_dir = _job_dir_of(args)
    addr_file = job_dir / AM_ADDRESS_FILE
    if not addr_file.is_file():
        print(f"no live AM address for {args.app_id} under "
              f"{job_dir.parent} (already finished, or wrong --workdir?)")
        return None
    token_file = job_dir / AM_TOKEN_FILE
    try:
        token = token_file.read_text().strip() \
            if token_file.is_file() else None
        addr = addr_file.read_text().strip()
    except OSError as e:   # e.g. 0600 token owned by the submitter
        print(f"cannot read AM credentials under {job_dir}: {e}")
        return None
    return job_dir, addr, token


def cmd_kill(args: argparse.Namespace) -> int:
    """Kill a RUNNING job from outside its submitting client (reference
    analogue: ``yarn application -kill``)."""
    from tony_tpu_torch.rpc import RpcClient, RpcError

    live = _live_am(args)
    if live is None:
        return 1
    _, addr, token = live
    try:
        with RpcClient(addr, token=token, timeout=10.0) as c:
            c.call("finish_application",
                   reason=f"killed via tony kill by {args.reason or 'cli'}")
    except (RpcError, OSError) as e:
        print(f"kill RPC failed: {e}")
        return 1
    print(f"kill requested for {args.app_id}")
    return 0


def cmd_logs(args: argparse.Namespace) -> int:
    """Print per-container logs of a job on the local substrate
    (reference analogue: ``yarn logs -applicationId``). Remote (ssh)
    containers keep their logs on their hosts."""
    job_dir = _job_dir_of(args)
    containers = sorted((job_dir / "containers").glob("*")) \
        if (job_dir / "containers").is_dir() else []
    if not containers:
        print(f"no container logs under {job_dir} "
              f"(wrong --workdir, or a remote-substrate job?)")
        return 1
    tail = max(0, args.tail)
    printed_any = False
    for cdir in containers:
        for name in (constants.EXECUTOR_LOG_NAME,
                     constants.USER_STDOUT_NAME, constants.USER_STDERR_NAME):
            f = cdir / name
            if not f.is_file() or f.stat().st_size == 0:
                continue
            printed_any = True
            # Bounded memory either way: deque for --tail, streamed
            # line-by-line otherwise — container logs can be GBs.
            with open(f, errors="replace") as fh:
                if tail:
                    shown = deque(fh, maxlen=tail)
                    print(f"===== {cdir.name}/{name} "
                          f"(last {len(shown)} lines) =====")
                    for line in shown:
                        print(line.rstrip("\n"))
                else:
                    print(f"===== {cdir.name}/{name} =====")
                    for line in fh:
                        print(line.rstrip("\n"))
    if not printed_any:
        print(f"no non-empty logs yet under {job_dir / 'containers'}")
        return 1
    return 0


def cmd_version(_args: argparse.Namespace) -> int:
    print(f"tony-torch {__version__}")
    return 0


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tony-torch",
        description="TonY's control plane for the PyTorch/CUDA port")
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("submit", help="submit a job and monitor to completion")
    s.add_argument("--src_dir", help="user source directory to stage")
    s.add_argument("--executes", help="command to run in each task container")
    s.add_argument("--conf_file", help="tony.xml / JSON job config")
    s.add_argument("--conf", action="append", metavar="KEY=VALUE",
                   help="config override (repeatable)")
    s.add_argument("--framework", help="pytorch|standalone")
    s.add_argument("--name", help="application name")
    s.add_argument("--python_venv", help="virtualenv archive/dir to ship")
    s.add_argument("--python_binary_path", help="python interpreter inside the venv")
    s.add_argument("--workdir", help="client work dir (default ~/.tony-tpu/jobs)")
    s.add_argument("--am_host", default="127.0.0.1",
                   help="address executors use to reach the AM")
    s.add_argument("--timeout", type=float, default=None,
                   help="client-side monitor timeout in seconds")
    s.add_argument("--quiet", action="store_true")
    s.set_defaults(fn=cmd_submit)

    sv = sub.add_parser("serve", help="serve a trained checkpoint: replica "
                        "containers of the port's continuous-batching "
                        "engine behind the RPC wire")
    sv.add_argument("--model", required=True,
                    help="registered model name (e.g. llama2-7b)")
    sv.add_argument("--model_kwargs", help="JSON dict of model kwargs "
                    "(quant lanes, layer count overrides, ...)")
    sv.add_argument("--ckpt_dir", default=None,
                    help="training checkpoint directory to serve")
    sv.add_argument("--gpus", type=int, default=0,
                    help="cards pinned to each replica "
                         "(tony.<jobtype>.gpus; 0 = no card ask)")
    sv.add_argument("--replicas", type=int, default=1,
                    help="replica count")
    sv.add_argument("--max_replicas", type=int, default=None,
                    help="autoscale ceiling (above --replicas it arms "
                         "the serve autoscaler, which the port's AM does "
                         "not have yet: refused)")
    sv.add_argument("--dtype_policy", default="bf16", choices=("bf16", "f32"),
                    help="restore-time cast: f32 master -> serving dtype")
    sv.add_argument("--ctx_max", type=int, default=2048,
                    help="max positions per sequence (KV buffer extent)")
    sv.add_argument("--prefix_cache", action="store_true",
                    help="arm block-level KV prefix sharing")
    sv.add_argument("--prefill_chunk", type=int, default=0,
                    help="chunked prefill rows per iteration (a 16-row "
                         "block multiple; 0 = monolithic)")
    sv.add_argument("--aot_cache", default=None, metavar="DIR",
                    help="persisted compile cache directory (kernel "
                         "libraries and captured step families)")
    sv.add_argument("--warm_standby", type=int, default=0,
                    help="warm-standby pool size (the AM's pool is not in "
                         "the port yet: refused)")
    sv.add_argument("--slo_target_ms", default="",
                    help="p99 target of SLO autoscaling (not in the "
                         "port's AM yet: refused)")
    sv.add_argument("--spec_k", type=int, default=0,
                    help="speculative decoding draft depth (0 = off)")
    sv.add_argument("--draft_model", help="registered draft model name "
                    "(omit for the self-drafting n-gram fallback)")
    sv.add_argument("--draft_model_kwargs",
                    help="JSON dict of draft model kwargs")
    sv.add_argument("--draft_ckpt_dir",
                    help="draft model checkpoint dir (default: the "
                         "target's --ckpt_dir)")
    sv.add_argument("--role", default=None, metavar="ROLE=N[,ROLE=N...]",
                    help="disaggregated prefill/decode split: per-role "
                         "gang sizes, e.g. 'prefill=1,decode=1' — each "
                         "role becomes its own jobtype and the router "
                         "ships KV blocks prefill -> decode over the RPC "
                         "wire; omit for the colocated fleet")
    sv.add_argument("--host_blocks", type=int, default=0,
                    help="host-RAM KV tier size in blocks (0 = off): "
                         "cold published stems demote to the host "
                         "instead of being dropped, and conversations "
                         "park between turns, so a resumed turn "
                         "prefills only its new tail")
    sv.add_argument("--prefix_store", default=None, metavar="DIR",
                    help="persisted prefix store directory: hot stems "
                         "commit to disk by stage and rename, and a "
                         "fresh replica adopts them on start")
    sv.add_argument("--demote_watermark", type=float, default=0.0,
                    help="pool occupancy fraction above which each "
                         "engine step demotes cold KV blocks into the "
                         "--host_blocks tier (0 = off)")
    sv.add_argument("--tenants", default=None, metavar="NAME:W[,NAME:W...]",
                    help="tenant classes with weighted-fair KV-block "
                         "budgets, e.g. gold:3,silver:1 (a bare name "
                         "weighs 1); absent, serving is the untagged "
                         "fleet's")
    sv.add_argument("--qos_max_queue", type=int, default=0,
                    help="per-tenant queue cap: past it a tenant's "
                         "submits get retryable back-pressure (0 = "
                         "unbounded; needs --tenants)")
    # The reference's flags for lanes the port does not serve: accepted
    # so that using one names its ROADMAP item.
    sv.add_argument("--mesh", default=None, help=argparse.SUPPRESS)
    sv.add_argument("--follow", default=None, help=argparse.SUPPRESS)
    sv.add_argument("--conf_file", help="tony.xml / JSON job config")
    sv.add_argument("--conf", action="append", metavar="KEY=VALUE")
    sv.add_argument("--name", help="application name")
    sv.add_argument("--workdir", help="client work dir")
    sv.add_argument("--am_host", default="127.0.0.1")
    sv.add_argument("--timeout", type=float, default=None)
    sv.add_argument("--quiet", action="store_true")
    sv.set_defaults(fn=cmd_serve)

    rt = sub.add_parser("route", help="run the fleet request router: "
                        "routes generate RPCs over the live replica set "
                        "by prefix-cache overlap and load")
    rt.add_argument("--am", required=True,
                    help="AM RPC address (host:port) to poll for the "
                         "live replica set")
    rt.add_argument("--port", type=int, default=0,
                    help="router RPC port (0 = any)")
    rt.add_argument("--block_size", type=int, default=16,
                    help="fleet KV block size (must match the replicas' "
                         "engine geometry: the chain keys are "
                         "block-aligned)")
    rt.add_argument("--cache_weight", type=float, default=4.0)
    rt.add_argument("--queue_weight", type=float, default=1.0)
    rt.add_argument("--p99_weight", type=float, default=0.5)
    rt.add_argument("--poll_s", type=float, default=2.0,
                    help="AM membership poll interval")
    rt.set_defaults(fn=cmd_route)

    k = sub.add_parser("kill", help="kill a running job (yarn "
                       "application -kill analogue)")
    k.add_argument("app_id", help="application id of a RUNNING job")
    k.add_argument("--workdir", help="client work dir (default ~/.tony-tpu/jobs)")
    k.add_argument("--reason", help="recorded in the job's final message")
    k.set_defaults(fn=cmd_kill)

    lg = sub.add_parser("logs", help="print per-container logs "
                        "(yarn logs analogue, local substrate)")
    lg.add_argument("app_id", help="application id")
    lg.add_argument("--workdir", help="client work dir (default ~/.tony-tpu/jobs)")
    lg.add_argument("--tail", type=int, default=0,
                    help="only the last N lines of each log (0 = all)")
    lg.set_defaults(fn=cmd_logs)

    v = sub.add_parser("version", help="print version")
    v.set_defaults(fn=cmd_version)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = make_parser().parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # stdout piped into a pager/head that exited; not an error.
        return 0

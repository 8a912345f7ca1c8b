"""Port parity for multi-tenant QoS (tony_tpu_torch.serve.qos and the
engine's budget-armed admission): the reference's tests/test_qos.py
rebuilt on the port, its budget math and tenant-isolation classes.

* ``parse_tenants`` and ``QosPolicy`` equal the JAX package's on every
  input: the reference's cases, and a hypothesis property over tenant
  sets, weights, active sets and pool sizes.
* Tenant isolation on the port's engine (bf16 weights, as the
  reference's tests serve): a victim tenant's tokens AND per-token
  logits under an aggressor burst are ``np.array_equal`` to an unloaded
  engine's; the aggressor, never the victim, is deferred; budgets off is
  byte-identical to an unarmed engine; the accounting drains to zero.
  Against the JAX package (f32 weights): the same burst makes the same
  deferrals and the same admission order, with equal tokens.

The history, events and autoscaler classes of tests/test_qos.py belong
to a later slice. llama-tiny, 2 layers, ctx_max 64, blocks of 8, on the
CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import flax.linen as nn
import jax
import jax.numpy as jnp

from tony_tpu import conf as jconf
from tony_tpu.models import get_model as jax_model
from tony_tpu.serve import Request as JRequest
from tony_tpu.serve import ServeEngine as JServeEngine
from tony_tpu.serve.qos import QosPolicy as JQosPolicy
from tony_tpu.serve.qos import parse_tenants as jparse_tenants
from tony_tpu_torch import conf as tconf
from tony_tpu_torch.models import get_model
from tony_tpu_torch.models.convert import load_jax_params
from tony_tpu_torch.serve import (AdmissionError, QosPolicy, Request,
                                  ServeEngine, parse_tenants)

ENGINE_KW = dict(ctx_max=64, block_size=8, q_block=16, decode_buckets=(2, 4),
                 max_running=4, keep_logits=True)


@pytest.fixture(scope="module")
def tiny():
    """The port's tiny decoder with bf16 weights and compute."""
    return get_model("llama-tiny", n_layers=2, dtype=torch.bfloat16,
                     param_dtype=torch.bfloat16, device="cpu", seed=0)


@pytest.fixture(scope="module")
def pair():
    """The JAX tiny decoder (f32) and the port's on the same weights."""
    jm = jax_model("llama-tiny", n_layers=2, dtype=jnp.float32)
    params = nn.unbox(jm.init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 16), jnp.int32)))["params"]
    tm = get_model("llama-tiny", n_layers=2, dtype=torch.float32,
                   device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return (jm, params), tm


def make_engine(model, **kw):
    return ServeEngine(model, **{"device": "cpu", **ENGINE_KW, **kw})


def _gold_silver(max_queue=0):
    return QosPolicy(classes=parse_tenants("gold:3,silver:1"),
                     max_queue=max_queue)


def _outcome(fn, *args):
    """``("ok", value)`` or ``("error", exception type name)``."""
    try:
        return "ok", fn(*args)
    except ValueError as e:
        return "error", type(e).__name__


# ---------------------------------------------------------------------------
# Tenant spec parsing and the weighted-fair budget (pure)
# ---------------------------------------------------------------------------

class TestParseTenants:
    def test_weighted_and_bare_names(self):
        assert parse_tenants("gold:3,silver:1") == {"gold": 3.0,
                                                    "silver": 1.0}
        assert parse_tenants("solo") == {"solo": 1.0}
        assert parse_tenants(" a :2 , b ") == {"a": 2.0, "b": 1.0}

    @pytest.mark.parametrize("spec", [
        "", " , ", ":3", "a:0", "a:-1", "a:nan", "a:x", "a:1,a:2"])
    def test_invalid_specs_raise(self, spec):
        with pytest.raises(ValueError):
            parse_tenants(spec)
        with pytest.raises(ValueError):
            jparse_tenants(spec)

    @settings(max_examples=200, deadline=None)
    @given(st.text(alphabet="ab:,. 0123-x", max_size=16))
    def test_equals_the_original_on_any_spec(self, spec):
        assert _outcome(parse_tenants, spec) == \
            _outcome(jparse_tenants, spec)


class TestQosPolicy:
    def test_budget_is_weighted_fair_share(self):
        p = QosPolicy(classes=parse_tenants("gold:3,silver:1"))
        active = {"gold", "silver"}
        assert p.budget("gold", 64, active) == 48
        assert p.budget("silver", 64, active) == 16

    def test_work_conserving_idle_tenant_redistributes(self):
        p = QosPolicy(classes=parse_tenants("gold:3,silver:1"))
        assert p.budget("gold", 64, {"gold"}) == 64
        assert p.budget("silver", 64, set()) == 64

    def test_floor_of_one_block(self):
        p = QosPolicy(classes={"big": 1000.0, "tiny": 1.0})
        assert p.budget("tiny", 4, {"big", "tiny"}) == 1

    def test_unknown_tenant_gets_default_weight(self):
        p = QosPolicy(classes={"gold": 3.0})
        assert p.weight("stranger") == 1.0
        assert p.budget("stranger", 64, {"gold", "stranger"}) == 16

    def test_from_conf_off_is_none(self):
        assert QosPolicy.from_conf(tconf.TonyConfig()) is None

    def test_from_conf_round_trip(self):
        kv = {tconf.SERVE_QOS_TENANTS: "gold:3,silver:1",
              tconf.SERVE_QOS_MAX_QUEUE: "5"}
        p = QosPolicy.from_conf(tconf.TonyConfig(kv))
        assert p.classes == {"gold": 3.0, "silver": 1.0}
        assert p.max_queue == 5
        j = JQosPolicy.from_conf(jconf.TonyConfig(kv))
        assert (p.classes, p.max_queue, p.default_weight) == \
            (j.classes, j.max_queue, j.default_weight)

    def test_invalid_policy_raises(self):
        with pytest.raises(ValueError):
            QosPolicy(classes={"a": -1.0})
        with pytest.raises(ValueError):
            QosPolicy(classes={"a": 1.0}, max_queue=-1)
        with pytest.raises(ValueError):
            QosPolicy(default_weight=0.0)

    @settings(max_examples=300, deadline=None)
    @given(weights=st.dictionaries(
               st.sampled_from(["gold", "silver", "bronze", "t3", "t4"]),
               st.floats(min_value=0.01, max_value=1000.0,
                         allow_nan=False), min_size=1, max_size=5),
           default=st.floats(min_value=0.01, max_value=100.0,
                             allow_nan=False),
           ask=st.sampled_from(["gold", "silver", "bronze", "t3", "t4",
                                "stranger"]),
           active=st.sets(st.sampled_from(["gold", "silver", "bronze",
                                           "t3", "stranger"])),
           n_blocks=st.integers(min_value=1, max_value=100_000))
    def test_budget_equals_the_original(self, weights, default, ask,
                                        active, n_blocks):
        p = QosPolicy(classes=dict(weights), default_weight=default)
        j = JQosPolicy(classes=dict(weights), default_weight=default)
        assert p.weight(ask) == j.weight(ask)
        assert p.budget(ask, n_blocks, active) == \
            j.budget(ask, n_blocks, active)
        assert 1 <= p.budget(ask, n_blocks, active) <= max(1, n_blocks)


# ---------------------------------------------------------------------------
# Tenant isolation on the engine
# ---------------------------------------------------------------------------

def _burst(rng, n_aggr=6):
    victims = [list(rng.randint(0, 256, n)) for n in (7, 9, 15)]
    aggr = [list(rng.randint(0, 256, 30)) for _ in range(n_aggr)]
    return victims, aggr


def _submit_burst(eng, req_cls, victims, aggr):
    """The aggressor burst first (enough long prefills to swallow the
    whole pool were budgets off), then the victim's requests."""
    for i, p in enumerate(aggr):
        eng.submit(req_cls(rid=f"a{i}", tokens=[int(t) for t in p],
                           max_new_tokens=8, tenant="aggr"))
    for i, p in enumerate(victims):
        eng.submit(req_cls(rid=f"v{i}", tokens=[int(t) for t in p],
                           max_new_tokens=4, tenant="victim"))


class TestTenantIsolation:
    def test_aggressor_burst_leaves_victim_bitwise_unchanged(self, tiny,
                                                             pair):
        """The victim tenant's tokens and per-token logits under an
        aggressor burst are bitwise an UNLOADED engine's, and the
        throttling lands on the aggressor (deferrals), never the victim.
        The JAX package's engine, given the same burst, defers as often
        and admits in the same order."""
        rng = np.random.RandomState(3)
        victims, aggr = _burst(rng)
        ref = make_engine(tiny)
        for i, p in enumerate(victims):
            ref.submit(Request(rid=f"v{i}", tokens=[int(t) for t in p],
                               max_new_tokens=4))
        ref_done = {c.rid: c for c in ref.run()}
        qos = QosPolicy(classes={"victim": 1.0, "aggr": 1.0})
        eng = make_engine(tiny, qos=qos)
        _submit_burst(eng, Request, victims, aggr)
        done = {c.rid: c for c in eng.run()}
        assert sorted(done) == sorted(
            [f"a{i}" for i in range(len(aggr))]
            + [f"v{i}" for i in range(len(victims))])
        for i in range(len(victims)):
            got, want = done[f"v{i}"], ref_done[f"v{i}"]
            assert got.tokens == want.tokens
            assert len(got.logits) == len(want.logits)
            for a, b in zip(got.logits, want.logits):
                assert np.array_equal(a, b)
        stats = eng.stats()
        assert stats["qos_deferrals"] > 0
        assert stats["admission_rejections"] == 0.0
        assert stats["tenants"]["victim"]["completed"] == float(len(victims))
        assert stats["tenants"]["victim"]["deferred"] == 0.0
        assert stats["tenants"]["aggr"]["deferred"] == stats["qos_deferrals"]
        # The reference, on f32 weights: the same scheduling decisions.
        (jm, params), tm = pair
        jqos = JQosPolicy(classes={"victim": 1.0, "aggr": 1.0})
        jeng = JServeEngine(jm, params, qos=jqos, **ENGINE_KW)
        teng = make_engine(tm, qos=qos)
        _submit_burst(jeng, JRequest, victims, aggr)
        _submit_burst(teng, Request, victims, aggr)
        jorder = [c.rid for c in jeng.run()]
        torder = [c.rid for c in teng.run()]
        assert torder == jorder
        assert teng.qos_deferrals == jeng.qos_deferrals
        assert teng.forwards == jeng.forwards

    def test_queue_cap_rejects_aggressor_with_typed_backpressure(
            self, tiny):
        eng = make_engine(tiny, qos=_gold_silver(max_queue=2))
        for i in range(2):
            eng.submit(Request(rid=f"a{i}", tokens=[1, 2, 3],
                               max_new_tokens=2, tenant="gold"))
        with pytest.raises(AdmissionError) as exc:
            eng.submit(Request(rid="a2", tokens=[1, 2, 3],
                               max_new_tokens=2, tenant="gold"))
        assert exc.value.retryable
        assert "gold" in str(exc.value)
        eng.submit(Request(rid="s0", tokens=[4, 5], max_new_tokens=2,
                           tenant="silver"))
        done = eng.run()
        assert sorted(str(c.rid) for c in done) == ["a0", "a1", "s0"]
        assert eng.stats()["admission_rejections"] == 1.0

    def test_budgets_off_is_byte_identical_to_unarmed_engine(self, tiny):
        """qos=None with tagged requests AND a qos engine with untagged
        requests both reproduce the unarmed engine bit for bit."""
        rng = np.random.RandomState(4)
        prompts = [list(rng.randint(0, 256, n)) for n in (5, 11, 17)]

        def run(qos=None, tenant=None):
            eng = make_engine(tiny, qos=qos)
            for i, p in enumerate(prompts):
                eng.submit(Request(rid=i, tokens=[int(t) for t in p],
                                   max_new_tokens=3, tenant=tenant))
            return eng, {c.rid: c for c in eng.run()}

        _, ref = run()
        _, tagged_no_qos = run(tenant="gold")
        armed_eng, untagged_qos = run(qos=_gold_silver())
        for variant in (tagged_no_qos, untagged_qos):
            for rid, want in ref.items():
                assert variant[rid].tokens == want.tokens
                for a, b in zip(variant[rid].logits, want.logits):
                    assert np.array_equal(a, b)
        stats = armed_eng.stats()
        assert stats["qos_deferrals"] == 0.0 and stats["tenants"] == {}

    def test_tenant_accounting_drains_to_zero(self, tiny):
        eng = make_engine(tiny, qos=_gold_silver())
        rng = np.random.RandomState(5)
        for i in range(3):
            eng.submit(Request(rid=i, tokens=[int(t) for t in
                                              rng.randint(0, 256, 9)],
                               max_new_tokens=3,
                               tenant="gold" if i % 2 else "silver"))
        eng.run()
        assert eng._tenant_blocks == {}
        assert eng.cache.free_blocks == eng.cache.n_blocks
        stats = eng.stats()
        assert stats["tenants"]["gold"]["blocks"] == 0.0
        assert stats["tenants"]["gold"]["completed"] \
            + stats["tenants"]["silver"]["completed"] == 3.0

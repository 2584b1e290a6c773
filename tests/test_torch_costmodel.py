"""The port's cost model (``repro_torch.opcost.CostMode``) and roofline
(``repro_torch.roofline``) against the JAX package's HLO walker
(``repro.hlocost``) and roofline: loops counted as often as they run, a
row read billed its row, the non-dot weights and ``model_flops`` equal,
the H100 terms, and the dot flops of SMOKE prefill and decode steps of
five families within 1 % of the walker's dot flops over the jitted
single-device HLO (the walker's count includes the f32 RMS statistics,
which XLA computes as dots and the port as products and a sum)."""
import pytest

pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro import hlocost, roofline as JR
from repro_torch import opcost, roofline as TR
from repro_torch.opcost import CostMode

import test_torch_lm_common as H
from test_torch_lm_common import _one_torch_thread  # noqa: F401

DOT_FAMILIES = ["stablelm_1_6b", "olmoe_1b_7b", "jamba_1_5_large",
                "rwkv6_3b", "whisper_small"]
DOT_TOL = 0.01


def walker_dot_flops(text: str) -> float:
    """The reference walker's dot flops alone, weighted by trip counts."""
    comps = hlocost._split_computations(text)
    shapes = {op.name: op.type_str for c in comps.values() for op in c.ops}
    total = 0.0

    def visit(comp, mult):
        nonlocal total
        for op in comp.ops:
            if op.opcode == "dot":
                total += mult * hlocost._dot_flops(op, shapes)
            trip = 1
            if op.opcode == "while":
                t = hlocost._TRIP.search(op.rest)
                trip = int(t.group(1)) if t else 1
            elif op.opcode not in ("fusion", "call", "conditional",
                                   "custom-call"):
                continue
            for n in hlocost._called_names(op.rest):
                if n in comps:
                    visit(comps[n], mult * trip)

    visit(next(c for c in comps.values() if c.is_entry), 1.0)
    return total


def test_loop_of_matmuls_counts_every_iteration():
    """10 (128 x 128) matmuls in a loop: 2 * 128^3 * 10 flops, as the
    walker counts the jitted lax.scan."""
    want = 2 * 128 ** 3 * 10

    def f(x, w):
        def body(c, _):
            return c @ w, None
        return jax.lax.scan(body, x, None, length=10)[0]

    x = jax.ShapeDtypeStruct((128, 128), jnp.float32)
    ref = hlocost.analyze_text(jax.jit(f).lower(x, x).compile().as_text())
    assert abs(ref.flops - want) / want < 0.01
    x, w = torch.randn(128, 128), torch.randn(128, 128)
    with CostMode() as cm:
        c = x
        for _ in range(10):
            c = c @ w
    assert cm.cost.flops == cm.cost.dot_flops == want
    assert cm.cost.loop_info == []
    assert cm.cost.op_counts == {"aten.mm.default": 10}


def test_nested_loops():
    want = 2 * 64 ** 3 * 15
    x, w = torch.randn(64, 64), torch.randn(64, 64)
    with CostMode() as cm:
        c = x
        for _ in range(3):
            for _ in range(5):
                c = c @ w
    assert cm.cost.dot_flops == want


def test_row_reads_are_billed_the_row():
    """A loop reading rows of a (1000, 128) buffer is billed each row
    (read twice: the view and the add's operand), not the buffer."""
    xs = torch.randn(1000, 128)
    with CostMode() as cm:
        c = torch.zeros(128)
        for t in range(1000):
            c = c + xs[t]
    assert cm.cost.eager_bytes < 10 * xs.numel() * 4
    assert cm.cost.eager_bytes == 128 * 4 + 1000 * 3 * 128 * 4


def test_nondot_weights_equal_reference():
    assert opcost.NONDOT_FLOP_WEIGHTS == hlocost.NONDOT_FLOP_WEIGHTS


def test_structured_ops_and_their_traffic():
    x = torch.randn(64, 32)
    cache = torch.zeros(8, 16)
    with CostMode() as cm:
        x.index_select(0, torch.tensor([3, 5, 7]))          # gather
        x.index_select(0, torch.tensor([9]))                # dynamic slice
        cache.index_copy_(0, torch.tensor([2]), torch.ones(1, 16))
        x.sum(0)                                            # reduce
        torch.cumsum(x, 1)                                  # window
        torch.sort(x, 1)                                    # sort
        torch.maximum(x, x)                                 # elementwise
    nd = cm.cost.nondot_flops
    assert nd["gather"] == 4.0 * 3 * 32
    assert nd["dynamic-slice"] == 2.0 * 32
    assert nd["dynamic-update-slice"] == 2.0 * 16
    assert nd["reduce"] == 2.0 * x.numel()
    assert nd["reduce-window"] == 8.0 * x.numel()
    assert nd["sort"] == 16.0 * x.numel()
    assert set(nd) == {"gather", "dynamic-slice", "dynamic-update-slice",
                       "reduce", "reduce-window", "sort"}
    assert cm.cost.flops_adjusted > cm.cost.flops
    with CostMode() as cm:
        x.index_select(0, torch.tensor([3, 5, 7]))
    assert cm.cost.eager_bytes == 2 * 3 * 32 * 4          # twice the window
    with CostMode() as cm:
        cache.index_copy_(0, torch.tensor([2]), torch.ones(1, 16))
    assert cm.cost.eager_bytes == 2 * 16 * 4 + 16 * 4     # the update + the ones
    assert opcost.storage_key(cache) in cm.cost.written


def test_workload_bytes_count_what_the_step_must_move():
    """The workload's bytes: an argument read as far as the ops read it (a
    gather: its rows), written in place as far as the ops wrote it (a
    scatter: its update, its destination unread), each at most once, and
    each new output once; temporaries are not counted."""
    x, cache = torch.randn(64, 32), torch.zeros(8, 16)
    p, g = torch.zeros(100), torch.ones(100)
    with CostMode() as cm:
        rows = x.index_select(0, torch.tensor([3, 5, 7]))
        cache.index_copy_(0, torch.tensor([2]), torch.ones(1, 16))
        for _ in range(3):                # re-reads cost nothing more
            p.add_(g * 2)
    got = TR.workload_bytes(cm.cost, [x, cache, p, g], [rows, cache, p])
    assert got == (3 * 32 * 4             # x: the gathered rows
                   + 16 * 4               # cache: the update, not read
                   + 2 * 100 * 4          # p: read once, written once
                   + 100 * 4              # g: read once
                   + 3 * 32 * 4)          # rows: a new output
    assert got < cm.cost.eager_bytes


def test_peak_counts_live_allocations():
    x = torch.randn(1024, 256)
    n = x.numel() * 4
    with CostMode() as cm:
        a = x * 2
        b = a + 1
        del a
        c = b * 3
        del b
        c.sum()
    assert cm.cost.peak_bytes == 2 * n
    with CostMode() as cm:
        x.mul_(1.0)                      # in place: no allocation
    assert cm.cost.peak_bytes == 0
    rep = TR.memory_report(cm.cost, [x], [x])
    assert rep["alias_size_in_bytes"] == rep["argument_size_in_bytes"] == n
    assert rep["resident_bytes"] == n


def test_collective_bytes():
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        x = torch.randn(16, 8)
        with CostMode() as cm:
            funcol.all_reduce(x, "sum", dist.group.WORLD).wait()
            funcol.all_gather_single(x, 0, dist.group.WORLD).wait()
    finally:
        dist.destroy_process_group()
    assert cm.cost.coll_breakdown == {"all-reduce": x.nbytes,
                                      "all-gather": x.nbytes}
    assert cm.cost.collective_bytes == 2 * x.nbytes


def test_roofline_terms_with_h100_constants():
    assert (TR.PEAK_FLOPS, TR.HBM_BW, TR.LINK_BW) == (989e12, 3.35e12, 450e9)
    r = TR.Roofline(
        arch="a", shape="s", mesh="m", n_chips=4,
        flops_per_device=989e12, bytes_per_device=3.35e12 * 2,
        coll_bytes_per_device=450e9 * 0.5, coll_breakdown={},
        model_flops=989e12 * 4 * 0.5, memory_report={},
        workload_bytes_per_device=3.35e12 * 0.25,
    )
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_memory_workload - 0.25) < 1e-9
    assert r.workload_bottleneck == "compute"
    assert abs(r.t_memory - 2.0) < 1e-9
    assert abs(r.t_collective - 0.5) < 1e-9
    assert r.bottleneck == "memory"
    assert abs(r.roofline_fraction - 0.5) < 1e-9
    assert abs(r.useful_flops_ratio - 0.5) < 1e-9
    j = JR.Roofline(arch="a", shape="s", mesh="m", n_chips=4,
                    flops_per_device=1.0, bytes_per_device=1.0,
                    coll_bytes_per_device=0.0, coll_breakdown={},
                    model_flops=1.0, memory_report={})
    # the reference's keys in its order, then the port's additions
    extra = ["eager_bytes_per_device", "workload_bytes_per_device",
             "t_memory_workload_s", "workload_bottleneck"]
    assert list(r.row()) == list(j.row()) + extra
    assert r.row()["eager_bytes_per_device"] == r.bytes_per_device


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_model_flops_equal_reference(arch):
    jm, tm = JC.get(arch), TC.get(arch)
    assert list(tm.CELLS) == list(jm.CELLS)
    for name, cell in tm.CELLS.items():
        want = JR.model_flops(jm.CONFIG, jm.CELLS[name])
        assert TR.model_flops(tm.CONFIG, cell) == want, name


@pytest.mark.parametrize("arch", DOT_FAMILIES)
def test_dot_flops_equal_walker(arch):
    from repro.models.transformer import build_model as jax_build
    from repro_torch.models.convert import params_to_jax

    jc, tc = H.configs(arch, dtype="float32")
    jm = jax_build(jc)
    tm = H.port_build(tc, device="cpu")
    params = jax.tree.map(lambda t: H.to_jax(t.numpy()), params_to_jax(
        tc, dict(tm.named_parameters())))
    rng = np.random.default_rng(0)
    prompt = H.prompt(jc, rng)
    step = H.step_inputs(jc, rng, n=1)[0]
    kw = {"enc_len": prompt["frames"].shape[1]} if jc.is_encoder_decoder \
        else {}
    if jc.family == "ssm":
        jcache, tcache = jm.init_cache(H.B), tm.init_cache(H.B)
    else:
        jcache = jm.init_cache(H.B, H.S + 8, **kw)
        tcache = tm.init_cache(H.B, H.S + 8, **kw)
    cases = [
        ("prefill", (params, {k: H.to_jax(v) for k, v in prompt.items()}),
         jm.prefill, lambda: tm.prefill(
             {k: H.to_torch(v) for k, v in prompt.items()})),
        ("decode", (params, {k: H.to_jax(v) for k, v in step.items()},
                    jcache),
         jm.decode_step, lambda: tm.decode_step(
             {k: H.to_torch(v) for k, v in step.items()}, tcache)),
    ]
    for what, args, ref_fn, port_fn in cases:
        want = walker_dot_flops(
            jax.jit(ref_fn).lower(*args).compile().as_text())
        with torch.no_grad(), CostMode() as cm:
            port_fn()
        got = cm.cost.dot_flops
        assert abs(got - want) <= DOT_TOL * want, (what, got, want)

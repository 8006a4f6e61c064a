"""The port's roofline (roofline/analysis.py, op_profile.py) against
the reference's machinery and PERF.md's kernel bounds: model FLOPs equal
the reference's on all 32 cells; the bound is the largest term; the
2/3-group probe extrapolation recovers a linear cost; the kernel work
formulas give the bounds chip_smoke.py printed (NVIDIA H100 80GB HBM3,
700.00 W) to 3 significant digits; the static op profile groups a meta
step's ops by kind; the kernel wrappers on meta tensors report their own
work and launch nothing."""
import types

import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # not installed: the property test is gated out
    given = settings = st = None

from repro.configs import ASSIGNED as JAX_ASSIGNED
from repro.roofline.analysis import model_flops as jax_model_flops
from repro_torch.configs import ASSIGNED, runnable_shapes
from repro_torch.kernels import bcq_matmul as tbm
from repro_torch.kernels import launch_counts, work
from repro_torch.kernels import paged_attention as tpa
from repro_torch.launch import dryrun as dr
from repro_torch.quant.kv import kv_bytes_per_token_head
from repro_torch.roofline import analysis as ra
from repro_torch.roofline.op_profile import (OpCounter, count_step,
                                             kernel_time_by_name, top_kernels)


def test_model_flops_equal_the_reference_on_every_cell():
    n = 0
    for name, cfg in ASSIGNED.items():
        for s in runnable_shapes(cfg):
            assert ra.model_flops(cfg, s) == jax_model_flops(
                JAX_ASSIGNED[name], s), (name, s.name)
            n += 1
    assert n == 32


def test_extrapolate_linear_recovery():
    """If cost is exactly base + g*delta, the 2/3-probe recovers it."""
    base, delta, G = 7.0, 3.0, 40
    c2 = {"flops": base + 2 * delta, "bytes": 10 + 2 * 2.0,
          "wire_bytes": 1 + 2 * 0.5, "coll_count": 8}
    c3 = {"flops": base + 3 * delta, "bytes": 10 + 3 * 2.0,
          "wire_bytes": 1 + 3 * 0.5, "coll_count": 11}
    out = dr._extrapolate(c2, c3, G)
    assert abs(out["flops"] - (base + G * delta)) < 1e-9
    assert abs(out["bytes"] - (10 + G * 2.0)) < 1e-9
    assert abs(out["wire_bytes"] - (1 + G * 0.5)) < 1e-9
    assert out["coll_count_per_group"] == 3


if given is not None:
    @given(st.floats(0, 1e15), st.floats(0, 1e15), st.floats(0, 1e15))
    @settings(max_examples=30, deadline=None)
    def test_roofline_bound_is_max_term(f, b, w):
        st_ = ra.CollectiveStats(total_wire_bytes=w)
        r = ra.roofline_terms({"flops": f, "bytes accessed": b}, st_)
        assert r["t_bound_s"] >= r["t_compute_s"] - 1e-12
        assert r["t_bound_s"] >= r["t_memory_s"] - 1e-12
        assert r["t_bound_s"] >= r["t_collective_s"] - 1e-12
        assert 0.0 <= r["roofline_mfu"] <= 1.0 + 1e-9


def test_one_card_has_no_collective_term():
    r = ra.roofline_terms({"flops": 989e12, "bytes accessed": 1.0},
                          ra.CollectiveStats())
    assert r["t_collective_s"] == 0.0 and r["bound"] == "compute"
    assert r["t_compute_s"] == pytest.approx(1.0)
    assert r["roofline_mfu"] == 1.0


def _sig3(x):
    return float(f"{x:.3g}")


def test_kernel_bounds_reproduce_the_recorded_ones():
    """PERF.md's kernel table: the GEMV at M=4 and the GEMM at M=128 on
    4096x11008 w3 per-channel fp32, the expert GEMV (E=128, M=4,
    4096x1536, a batch-4 top-8 routing: 29 live experts, 32 live rows)
    and fp attention (B=4, Hkv 32, rep 1, hd 128, contexts 50/80/110/
    131 in 64-token pages)."""
    gemv = ra.bcq_work(4, 4096, 11008, 3, 1)
    assert _sig3(ra.bcq_bound_ms(gemv, 4)[0]) == 0.00538
    assert ra.bcq_bound_ms(gemv, 4)[1:] == ("operations", "fp32")
    gemm = ra.bcq_work(128, 4096, 11008, 3, 1)
    assert _sig3(ra.bcq_bound_ms(gemm, 128)[0]) == 0.0700
    assert ra.bcq_bound_ms(gemm, 128)[1:] == ("operations", "tf32x3")
    live = [1] * 26 + [2] * 3 + [0] * 99
    expert = ra.bcq_work(4, 4096, 1536, 3, 1, live_rows=live, E=128)
    assert sum(live) == 32
    assert _sig3(ra.bcq_bound_ms(expert, 4)[0]) == 0.0217
    assert ra.bcq_bound_ms(expert, 4)[1] == "bytes"
    ctx = [50, 80, 110, 131]
    attn = ra.paged_attention_work(
        sum(ctx), 4, 32, 1, 128, 3,
        kv_bytes_per_token_head=kv_bytes_per_token_head(128, 0))
    ms, by = ra.bound_ms(attn["bytes"], attn["flops"])
    assert (_sig3(ms), by) == (0.00367, "bytes")


def test_indexed_reads_move_their_rows_only():
    table = torch.empty((1000, 64), device="meta")
    idx = torch.empty((2, 3), dtype=torch.long, device="meta")
    out, cost = count_step(lambda: table[idx], (table, idx))
    assert tuple(out.shape) == (2, 3, 64)
    # the indices, and the 6 rows read and written
    assert cost["bytes"] == 6 * 8 + 2 * 6 * 64 * 4


def test_op_profile_groups_by_kind():
    a = torch.empty((128, 128), device="meta")
    b = torch.empty((128, 128), device="meta")

    def step():
        d = a @ b
        return d.to(torch.bfloat16).t()
    out, cost = count_step(step, (a, b))
    kinds = dict(cost["profile"]["by_kind"])
    assert kinds["mm.default"]["bytes"] == 128 * 128 * 4
    assert kinds["_to_copy.default"]["count"] == 1
    assert "t.default" not in kinds          # a view moves nothing
    assert cost["flops"] == 2 * 128 ** 3
    # mm reads a, b and writes d; the copy reads d, writes the bf16 out
    assert cost["bytes"] == 3 * 128 * 128 * 4 + 128 * 128 * (4 + 2)
    # a, b, d and the bf16 copy alive at once at the copy
    assert cost["peak_live_bytes"] == 3 * 128 * 128 * 4 + 128 * 128 * 2
    assert out.device.type == "meta"


def test_views_move_nothing():
    """Views, announced by their schema or not (a batched matmul's
    reshape of its result is an _unsafe_view), move no bytes."""
    a = torch.empty((4, 8, 16), device="meta")
    b = torch.empty((16, 32), device="meta")
    _, cost = count_step(lambda: a @ b, (a, b))
    kinds = dict(cost["profile"]["by_kind"])
    assert "_unsafe_view.default" not in kinds
    assert cost["bytes"] == 4 * (4 * 8 * 16 + 16 * 32 + 4 * 8 * 32)


def test_live_bytes_fall_when_storages_free():
    a = torch.empty((1024,), device="meta")

    def step():
        for _ in range(4):
            t = a * 2          # each product freed before the next
            del t
        return a + 1
    oc = OpCounter()
    oc.track([a])
    with oc:
        step()
    assert oc.peak_live_bytes == 2 * 4096       # a and one product
    assert oc.live_bytes == 4096                # the sum freed: a alone
    assert oc.n_ops == 5


def test_indexed_writes_move_their_rows_only():
    cache = torch.empty((8, 1024, 64), device="meta")
    rows = torch.empty((8, 64), device="meta")
    idx = torch.empty((8,), dtype=torch.long, device="meta")

    def step():
        cache[torch.arange(8, device="meta"), idx] = rows
    _, cost = count_step(step, (cache, rows, idx))
    # the arange written; then the two index tensors and the rows read
    # and the rows written, not the 2 MB cache
    assert cost["bytes"] == 64 + 2 * (64 + 64 + 8 * 64 * 4)


def test_kernel_wrappers_on_meta_report_work_and_launch_nothing():
    before = launch_counts()
    x = torch.empty((4, 4096), device="meta")
    codes = torch.empty((3, 128, 11008), dtype=torch.int32, device="meta")
    al = torch.empty((1, 11008, 3), device="meta")
    be = torch.empty((1, 11008), device="meta")
    with work.recording() as rec:
        y = tbm.bcq_gemv(x, codes, al, be)
        z = tbm.bcq_matmul(torch.empty((128, 4096), device="meta"), codes,
                           al, be)
        ye = tbm.bcq_expert_matmul(
            torch.empty((8, 4, 4096), device="meta"), codes.expand(
                8, *codes.shape), al.expand(8, *al.shape),
            be.expand(8, *be.shape))
        q = torch.empty((4, 32, 1, 128), device="meta")
        kp = torch.empty((20, 64, 32, 128), device="meta")
        bt = torch.empty((4, 3), dtype=torch.int32, device="meta")
        cl = torch.empty((4,), dtype=torch.int32, device="meta")
        o = tpa.paged_attention(q, kp, kp, bt, cl)
        pool = [torch.empty((20, 64, 32, 4, 4), dtype=torch.int32,
                            device="meta"),
                torch.empty((20, 64, 32, 1, 4), device="meta"),
                torch.empty((20, 64, 32, 1), device="meta")] * 2
        oq = tpa.paged_attention_quant(q, *pool, bt, cl)
    assert launch_counts() == before
    assert tuple(y.shape) == (4, 11008) and y.device.type == "meta"
    assert tuple(z.shape) == (128, 11008)
    assert tuple(ye.shape) == (8, 4, 11008)
    assert tuple(o.shape) == tuple(oq.shape) == (4, 32, 1, 128)
    k = rec.by_kernel
    gemv = ra.bcq_work(4, 4096, 11008, 3, 1)
    assert k["bcq_gemv"] == {"calls": 1, "flops": gemv["flops"],
                             "bytes": gemv["bytes"]}
    assert k["bcq_matmul"]["flops"] == 2.0 * 128 * 4096 * 11008
    assert k["bcq_expert_matmul"]["flops"] == 2.0 * 8 * 4 * 4096 * 11008
    # the codes, not fp32 weights: under 4 bits a weight
    assert k["bcq_gemv"]["bytes"] < 4096 * 11008 * 0.5
    assert k["paged_attention"]["bytes"] == ra.paged_attention_work(
        4 * 3 * 64, 4, 32, 1, 128, 3,
        kv_bytes_per_token_head=512)["bytes"]
    assert k["paged_attention_quant"]["bytes"] == ra.paged_attention_work(
        4 * 3 * 64, 4, 32, 1, 128, 3,
        kv_bytes_per_token_head=kv_bytes_per_token_head(128, 4))["bytes"]


def test_trace_grouping_by_kernel_name():
    def ev(name, us):
        return types.SimpleNamespace(
            name=name, time_range=types.SimpleNamespace(
                elapsed_us=lambda: us))
    by = kernel_time_by_name([ev("gemv", 30.0), ev("attn", 10.0),
                              ev("gemv", 20.0)])
    assert by == {"gemv": 50.0, "attn": 10.0}
    assert top_kernels(by, steps=2) == [{"name": "gemv", "ms": 0.025},
                                        {"name": "attn", "ms": 0.005}]

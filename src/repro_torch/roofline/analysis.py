"""Roofline terms against one NVIDIA H100 (the reference's
`roofline/analysis.py`, for the card instead of a TPU pod).

  compute term    = FLOPs / peak FLOP/s of the cell's arithmetic
  memory term     = bytes / HBM bandwidth
  collective term = collective wire bytes / NVLink bandwidth

On one card the collective term is 0: nothing crosses a link. The
reference reads its collectives from compiled HLO text
(`parse_collectives`); the port has no HLO, and a mesh's collective
term is still to do (ROADMAP Queue 1 item 6.3).

Beside the cell terms, one formula for a kernel's bound (`bound_ms`:
the larger of its bytes over the HBM rate and its operations over the
peak of its arithmetic) and the work of each hand-written kernel
(`bcq_work`, `paged_attention_work`): each input read once, each
output written once, the operations of the math. The kernel wrappers
report that work on meta tensors (kernels/work.py), and chip_smoke.py
bounds its timed rows with it.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.hw import GEMV_ROWS, WORD

# NVIDIA H100 SXM peaks: NVIDIA's H100 data sheet (dense, no sparsity,
# at the 700 W power limit); a card set below 700 W runs slower under
# load, so every measurement states the card's limit beside it.
HBM_BYTES_PER_S = 3.35e12   # HBM3, 80 GB (data sheet)
FP32_FLOPS = 67e12          # fp32 on the CUDA cores (data sheet)
TF32_FLOPS = 495e12         # TF32 tensor cores, dense (data sheet)
BF16_FLOPS = 989e12         # bf16 tensor cores, dense (data sheet)
NVLINK_BYTES_PER_S = 450e9  # NVLink 4, each way of 900 GB/s (data sheet)
HBM_BYTES = 80e9            # device memory of one card (data sheet)


@dataclass
class CollectiveStats:
    """Collective traffic of a step: none on one card."""
    total_wire_bytes: float = 0.0
    by_op: dict = field(default_factory=dict)
    count: int = 0
    top: list = field(default_factory=list)


def roofline_terms(cost: dict, coll: CollectiveStats,
                   peak: float = BF16_FLOPS) -> dict:
    """The three terms of a step of `cost` {"flops", "bytes accessed"}
    on one card whose arithmetic peaks at `peak`, the bound (the
    largest), and the share of the bound that is compute."""
    flops = float(cost.get("flops", 0.0))
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    t_compute = flops / peak
    t_memory = bytes_acc / HBM_BYTES_PER_S
    t_coll = coll.total_wire_bytes / NVLINK_BYTES_PER_S
    dom = max((t_compute, "compute"), (t_memory, "memory"),
              (t_coll, "collective"))
    return {
        "flops_per_device": flops,
        "bytes_per_device": bytes_acc,
        "collective_bytes_per_device": coll.total_wire_bytes,
        "peak_flops": peak,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "bound": dom[1],
        "t_bound_s": dom[0],
        # the compute term's share of the bound: the model-FLOP ceiling
        # under this binding
        "roofline_mfu": (t_compute / dom[0]) if dom[0] > 0 else 0.0,
    }


def model_flops(cfg, shape_spec) -> float:
    """MODEL_FLOPS = 6 N_active D for train, 2 N_active D for inference
    (a generated token a sequence for decode). The whole step's, on
    however many devices."""
    n_active = cfg.param_counts()["active"]
    toks = shape_spec.seq_len * shape_spec.global_batch
    if shape_spec.kind == "train":
        return 6.0 * n_active * toks
    if shape_spec.kind == "prefill":
        return 2.0 * n_active * toks
    return 2.0 * n_active * shape_spec.global_batch


def bound_ms(n_bytes: float, flops: float, peak: float = FP32_FLOPS):
    """The least time of the work in ms: its bytes at the HBM rate or
    its operations at `peak`, whichever is longer, and which it was
    ("bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# the hand-written kernels' work
# ---------------------------------------------------------------------------

def gemm_passes(x_itemsize: int) -> tuple:
    """The tensor-core BCQ GEMM's arithmetic for x of `x_itemsize`
    bytes: three TF32 passes for fp32 x (3xTF32), one for bf16 x;
    (name, passes)."""
    return ("tf32", 1) if x_itemsize == 2 else ("tf32x3", 3)


def bcq_work(M, K, N, bits, G, *, live_rows=None, E=1, x_itemsize=4,
             scale_itemsize=4) -> dict:
    """Bytes and operations of one BCQ kernel call (GEMV, GEMM or the
    expert stack of E matrices) on x (E, M, K), K the packed rows (a
    multiple of 32): the code words of the `bits` active planes, alphas
    (G, N, bits) and betas (G, N) of every expert with a live row, the
    live rows of x, all of y; 2 x live rows x K x N operations.
    `live_rows`: each expert's live rows (None: all M of each)."""
    rows = [M] * E if live_rows is None else list(live_rows)
    used = sum(r > 0 for r in rows)
    kw = -(-K // WORD)
    weights = used * (bits * kw * N * 4
                      + (G * N * bits + G * N) * scale_itemsize)
    n_bytes = weights + sum(rows) * K * x_itemsize + E * M * N * x_itemsize
    return {"bytes": n_bytes, "flops": 2 * sum(rows) * K * N}


def bcq_bound_ms(work: dict, M: int, x_itemsize: int = 4):
    """bound_ms of a BCQ call's `work`: the GEMV (M <= GEMV_ROWS rows)
    on the CUDA cores in fp32, the GEMM on the TF32 tensor cores at its
    passes. -> (ms, "bytes" | "operations", arithmetic)."""
    if M <= GEMV_ROWS:
        return (*bound_ms(work["bytes"], work["flops"]), "fp32")
    arith, passes = gemm_passes(x_itemsize)
    return (*bound_ms(work["bytes"], passes * work["flops"], TF32_FLOPS),
            arith)


def paged_attention_work(tokens, B, Hkv, rep, hd, n_table, *,
                         kv_bytes_per_token_head, q_itemsize=4) -> dict:
    """Bytes and operations of one paged-attention call over `tokens`
    live tokens in all: each live token's K and V vector of each KV
    head (`kv_bytes_per_token_head` bytes each), q read and the output
    written, the block tables and context lengths; 4 x tokens x heads x
    hd operations (q.k and p.v)."""
    n_bytes = (2 * tokens * Hkv * kv_bytes_per_token_head
               + 2 * B * Hkv * rep * hd * q_itemsize
               + B * n_table * 4 + B * 4)
    return {"bytes": n_bytes, "flops": 4 * tokens * Hkv * rep * hd}


"""The benchmark's frozen copy of the port's bound arithmetic: the least
time one H100 SXM could take for a kernel's work, which the per-layer
``*_roofline`` metrics divide by the kernel's device time.

A copy, so that a change to the program cannot move the yardstick; the
benchmark imports nothing of the program's own ``roofline.py``.

A bound is the larger of two times: the bytes the function must move
(each input read once, each output written once) over the memory rate,
and the operations it does over the peak rate of their arithmetic.
Peaks are NVIDIA's H100 SXM data sheet, dense, at the power limit
:data:`POWER_LIMIT_W`; a run prints its card's own limit beside them.
"""

#: the power limit, watts, at which the data sheet's peaks hold
POWER_LIMIT_W = 700.0


#: HBM3 rate, bytes/s
HBM_BYTES_PER_S = 3.35e12
#: peak rates, operations/s: tensor cores in bf16 and TF32, CUDA cores fp32.
#: "fp32 product" is a product of fp32 grade, as the port's parity rule
#: takes it: true fp32 on the CUDA cores or error-compensated 3xTF32 on the
#: tensor cores (three TF32 products for one), whichever is faster
PEAK_OPS_PER_S = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
PEAK_OPS_PER_S["fp32 product"] = max(PEAK_OPS_PER_S["fp32"],
                                     PEAK_OPS_PER_S["tf32"] / 3)


def bound(nbytes: float, ops: dict) -> dict:
    """{"ms", "by", "bytes", "ops"}: the larger of the byte time and the
    summed operation times; ``ops`` maps an arithmetic of
    :data:`PEAK_OPS_PER_S` to a count."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(count / PEAK_OPS_PER_S[kind] for kind, count in ops.items())
    return {"ms": 1e3 * max(t_bytes, t_ops),
            "by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": dict(ops)}


def _size(dtype_name: str) -> int:
    return {"float32": 4, "bfloat16": 2}[dtype_name]


def _assign_parts(n: int, f: int, k: int, dtype_name: str) -> tuple:
    size = _size(dtype_name)
    product = 2.0 * n * k * f
    ops = ({"bf16": product} if dtype_name == "bfloat16"
           else {"fp32 product": product})
    # fp32 storage takes the panel as its TF32 hi/lo pair
    panels = 1 if dtype_name == "bfloat16" else 2
    nbytes = (n * f * size + panels * k * f * size
              + 4 * k                  # c_sq
              + 4 * (k + 1) * f        # rescore table
              + n + 4 * n              # valid, prev
              + 4 * n + 4 * n + 4)     # assignment, best, changed
    return nbytes, ops


def assign_bound(n: int, f: int, k: int, dtype_name: str) -> dict:
    """B2 (``kmt_assign``) at (n, f, k) with x stored as ``dtype_name``
    ("float32" or "bfloat16")."""
    return bound(*_assign_parts(n, f, k, dtype_name))


def segment_sum_bound(n: int, f: int, k: int, dtype_name: str) -> dict:
    """B1's segment sum: one read of x and the assignment, one write of the
    (k, f) fp32 sums and the counts; n * f fp32 adds."""
    nbytes = n * f * _size(dtype_name) + 4 * n + 4 * k * f + 4 * k
    return bound(nbytes, {"fp32": float(n) * f})


def fused_bound(n: int, f: int, k: int, dtype_name: str) -> dict:
    """B1: B2 and the segment sum, x read once."""
    nbytes, ops = _assign_parts(n, f, k, dtype_name)
    nbytes += 4 * k * f + 4 * k
    ops["fp32"] = float(n) * f
    return bound(nbytes, ops)


def walk_bound(examined: int, member_rows: int, queries: int, f: int,
               kk: int, chunks: int, dtype_name: str) -> dict:
    """B3 (``kmt_knn_walk``) on one batch: a product of 2 f operations per
    examined (query, member) pair, as this run's data needs them, at the
    storage dtype's rate (bf16 on the tensor cores, as ``_assign_parts``
    counts it; fp32-grade for fp32); one read of the queries and of the
    distinct member rows the walks visited, one write of the (queries, kk)
    candidates and the per-chunk counts."""
    size = _size(dtype_name)
    nbytes = ((queries + member_rows) * f * size + 4 * queries * kk
              + 12 * chunks)
    kind = "bf16" if dtype_name == "bfloat16" else "fp32 product"
    return bound(nbytes, {kind: 2.0 * f * examined})


def point_min_bound(n: int, f: int, dtype_name: str, *, first: bool) -> dict:
    """The init step (``kmt_point_min``) over x (n, f) stored as
    ``dtype_name``: one read of x, of x_sq (fp32) and of the fp32 point c;
    the first step reads valid (bool) and writes the fp32 running minimum,
    a later one reads and writes it and never reads valid; 2 f fp32
    operations a row (a multiply-add per feature)."""
    per_row = f * _size(dtype_name) + 4 + (1 + 4 if first else 8)
    return bound(n * per_row + 4 * f, {"fp32": 2.0 * n * f})


def delta_sum_bound(m: int, f: int, k: int, dtype_name: str) -> dict:
    """The sparse iteration's delta (``kmt_delta_sum``) over m moved rows of
    x (n, f) stored as ``dtype_name``: one read of each moved row, of the
    int32 row list and of the two ids a listed row carries, one write of
    the (k, f) fp32 delta and the int32 counts; each moved row is added to
    one cluster and taken from another, 2 m f fp32 adds.  The kernel reads
    each moved row once a side, twice the rows' bytes here."""
    nbytes = m * f * _size(dtype_name) + 12 * m + 4 * k * f + 4 * k
    return bound(nbytes, {"fp32": 2.0 * m * f})


def draw_bound(n: int, f: int, dtype_name: str) -> dict:
    """The k-means++ step's weighted draw (``kmt_weighted_draw``) over n
    fp32 weights: one read of the weights and of the fp32 uniform, one
    write of the int64 index, and a row of f features stored as
    ``dtype_name``, its read and its fp32 write; n fp32 adds.  The bool
    valid rows are read only on the all-zero fallback (no weight
    positive), which the bound does not count."""
    nbytes = 4 * n + 4 + 8 + f * (_size(dtype_name) + 4)
    return bound(nbytes, {"fp32": float(n)})


def walk_ops_bound(examined: int, f: int, dtype_name: str) -> dict:
    """B3's operations alone: 2 f per examined (query, member) pair at the
    storage dtype's rate.  Less than :func:`walk_bound`, which adds the
    bytes of the distinct member rows, a count the program does not
    report; so a share of it is never above a share of the whole bound."""
    kind = "bf16" if dtype_name == "bfloat16" else "fp32 product"
    return bound(0.0, {kind: 2.0 * f * examined})


#: the host link of one card, bytes/s a direction: PCIe Gen5 x16, 32 GT/s
#: on 16 lanes, before its 128b/130b coding (the H100 SXM's host link;
#: ``nvidia-smi -q`` reads the link as N/A in the benchmark's sandboxed
#: machines, where one card copies 45-55 GB/s from page-locked memory,
#: past Gen4 x16's 32 GB/s)
HOST_LINK_BYTES_PER_S = 32e9 * 16 / 8


def host_copy_bound(n: int, f: int, dtype_name: str, cards: int) -> dict:
    """Samples (n, f) stored as ``dtype_name`` copied from host memory onto
    ``cards`` cards, one row shard a card, each over its own link at
    :data:`HOST_LINK_BYTES_PER_S`: every byte crosses a link once."""
    nbytes = float(n) * f * _size(dtype_name)
    return {"ms": 1e3 * nbytes / (cards * HOST_LINK_BYTES_PER_S),
            "by": "host link", "bytes": nbytes, "ops": {}}

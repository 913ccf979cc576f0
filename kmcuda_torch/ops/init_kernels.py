"""The k-means++ / AFK-MC2 step kernels and their plain-torch twins.

:func:`point_min` is the step of the init loops (``models.
initialization``): the distance of every row to one new centroid, folded
into the running minimum.  It replaces the step XLA fuses in the JAX
package (``kmcuda_tpu/ops/distance.py:point_distances``, its product at
:220, inside the on-device loop of ``kmcuda_tpu/models/
initialization.py:162-167``): x is read once in its storage dtype with
fp32 accumulation, and no (n, f) temporary is made.

On a CUDA tensor the wrapper launches ``kmt_point_min``
(``csrc/init_step.cu``), built at first use (see ``ops._build``).  On a
CPU tensor, and only there, it runs :func:`point_min_reference`, the
composition of ``ops.distance.point_distances``, ``torch.where`` and
``torch.minimum`` the loops ran before, which the CPU tests hold against
the JAX package and ``chip_smoke.py`` holds the kernel against on the
card.  Any other device raises.

:func:`weighted_draw` is the step's draw: one row ~ Categorical(w) by
inverse CDF, in a summation order fixed by n alone, so a k-means++ start on
the card is a function of the data and the seed.  It replaces the draw the
JAX package leaves to XLA (``kmcuda_tpu/models/initialization.py:87``
``_weighted_draw``) and the torch composition the port ran before (block
sums, ``torch.cumsum``, ``searchsorted``; ``chip_profile.py`` keeps it to
reproduce its fault), whose CUDA ``cumsum`` adds its prefixes in an order
scheduling sets.  On a CUDA tensor the wrapper
launches ``kmt_weighted_draw`` (``csrc/draw.cu``: the chunk partials, then
one block's pick, which also copies the drawn row); on a CPU tensor it
runs :func:`weighted_draw_reference`, the same tree in plain torch,
bitwise the kernel's index; the CPU init loops draw through it.
"""

import torch

from kmcuda_torch.ops import _build
from kmcuda_torch.ops import distance as D
from kmcuda_torch.utils.errors import KMTPUInvalidArguments

#: kernel launches per entry; the wrapper adds one where it launches
LAUNCHES = {"point_min": 0, "weighted_draw": 0}

#: rows one partial of the weighted draw covers (``csrc/draw.cu`` CHUNK):
#: quads of 4 rows, lines of 32 quads, chunks of 32 lines
DRAW_CHUNK = 4096
#: the draw's root covers this many groups of chunk partials (32 x 32)
DRAW_GROUPS = 1024


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_args(x, x_sq, valid, c, m) -> None:
    for name, t in (("x", x), ("x_sq", x_sq), ("valid", valid), ("c", c),
                    ("m", m)):
        if not isinstance(t, torch.Tensor):
            raise TypeError("%s must be a torch.Tensor" % name)
        if t.device != x.device:
            raise KMTPUInvalidArguments(
                "%s is on %s, x on %s" % (name, t.device, x.device))
        if not t.is_contiguous():
            raise KMTPUInvalidArguments("%s must be contiguous" % name)
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise KMTPUInvalidArguments(
            "x must be (n, f) float32 or bfloat16, got %s %s"
            % (tuple(x.shape), x.dtype))
    n, f = x.shape
    for name, t, dtype, shape in (
            ("x_sq", x_sq, torch.float32, (n,)),
            ("valid", valid, torch.bool, (n,)),
            ("c", c, torch.float32, (f,)), ("m", m, torch.float32, (n,))):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise KMTPUInvalidArguments(
                "%s must be %s %s, got %s %s" % (name, shape, dtype,
                                                 tuple(t.shape), t.dtype))
    if x.device.type not in ("cpu", "cuda"):
        raise KMTPUInvalidArguments("unsupported device %s" % x.device)


def point_min(x, x_sq, valid, c, m, metric: D.DistanceMetric, *,
              first: bool):
    """One init step, in place: ``m`` becomes ``where(valid, d, 0)`` when
    ``first``, else ``minimum(m, d)``, with d (n,) the distance of each row
    of ``x`` (n, f; fp32 or bf16) to the fp32 point ``c`` (f,): the
    product takes ``c`` rounded to the storage dtype, |c|^2 the fp32 ``c``.
    ``x_sq`` (n,) fp32, ``valid`` (n,) bool, ``m`` (n,) fp32.  Returns
    ``m``."""
    _check_args(x, x_sq, valid, c, m)
    if x.device.type == "cpu":
        return point_min_reference(x, x_sq, valid, c, m, metric, first=first)
    lib = _build.library()
    with torch.cuda.device(x.device):
        code = lib.kmt_point_min(
            x.data_ptr(), x_sq.data_ptr(), valid.data_ptr(), c.data_ptr(),
            m.data_ptr(), x.shape[0], x.shape[1],
            int(x.dtype == torch.bfloat16),
            int(metric == D.DistanceMetric.COSINE), int(first),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "kmt_point_min")
    LAUNCHES["point_min"] += 1
    return m


def point_min_reference(x, x_sq, valid, c, m, metric: D.DistanceMetric, *,
                        first: bool):
    """Plain twin of :func:`point_min`: ``point_distances`` then
    ``torch.where`` (first step) or ``torch.minimum`` into ``m``."""
    d = D.point_distances(x, x_sq, c, metric)
    if first:
        return m.copy_(torch.where(valid, d, 0.0))
    return torch.minimum(m, d, out=m)


def draw_partials(n: int) -> int:
    """The draw's chunk partials for n rows: ceil(n / DRAW_CHUNK)."""
    return -(-n // DRAW_CHUNK)


def draw_margin(n: int) -> float:
    """How far from a row boundary of the exact inverse CDF (relative to
    the total weight) the draw over n rows may pick the other row: each
    running sum on its path adds at most 4 + 32 + 32 + R + 32 + 32 values
    (R partials a group), the descent subtracts six times, ``u * total``
    rounds once; 2**-24 each."""
    groups = -(-draw_partials(n) // DRAW_GROUPS)
    return (groups + 4 + 4 * 32 + 8) * 2.0**-24


def _check_draw_args(w, valid, u, row_source, out_row) -> None:
    named = [("w", w), ("valid", valid), ("u", u)]
    if (row_source is None) != (out_row is None):
        raise KMTPUInvalidArguments(
            "row_source and out_row go together: give both or neither")
    if row_source is not None:
        named += [("row_source", row_source), ("out_row", out_row)]
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError("%s must be a torch.Tensor" % name)
        if t.device != w.device:
            raise KMTPUInvalidArguments(
                "%s is on %s, w on %s" % (name, t.device, w.device))
        if not t.is_contiguous():
            raise KMTPUInvalidArguments("%s must be contiguous" % name)
    if w.device.type not in ("cpu", "cuda"):
        raise KMTPUInvalidArguments("unsupported device %s" % w.device)
    if w.dim() != 1 or w.dtype != torch.float32 or w.numel() < 1:
        raise KMTPUInvalidArguments("w must be (n,) float32 with n >= 1, "
                                    "got %s %s" % (tuple(w.shape), w.dtype))
    n = w.shape[0]
    for name, t, dtype, shape in (("valid", valid, torch.bool, (n,)),
                                  ("u", u, torch.float32, (1,))):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise KMTPUInvalidArguments(
                "%s must be %s %s, got %s %s" % (name, shape, dtype,
                                                 tuple(t.shape), t.dtype))
    if row_source is None:
        return
    if (row_source.dim() != 2 or row_source.shape[0] != n
            or row_source.dtype not in (torch.float32, torch.bfloat16)):
        raise KMTPUInvalidArguments(
            "row_source must be (%d, f) float32 or bfloat16, got %s %s"
            % (n, tuple(row_source.shape), row_source.dtype))
    f = row_source.shape[1]
    if tuple(out_row.shape) != (f,) or out_row.dtype != torch.float32:
        raise KMTPUInvalidArguments(
            "out_row must be (%d,) float32, got %s %s"
            % (f, tuple(out_row.shape), out_row.dtype))


def weighted_draw(w, valid, u, *, row_source=None, out_row=None):
    """One row ~ Categorical(w) at the uniform ``u`` (1,) fp32 in [0, 1):
    w (n,) fp32 >= 0, over ``valid`` (n,) bool instead when no weight is
    positive; ``u * total`` is held below the total, so a row of weight 0
    is never drawn while any weight is positive.  Returns the (1,) int64
    index on w's device, with no host read.  With ``row_source`` (n, f)
    fp32 or bf16 and ``out_row`` (f,) fp32, also copies that row as fp32
    into ``out_row`` (in the kernel on the card)."""
    _check_draw_args(w, valid, u, row_source, out_row)
    if w.device.type == "cpu":
        idx = weighted_draw_reference(w, valid, u)
        if row_source is not None:
            out_row.copy_(row_source.index_select(0, idx)[0])
        return idx
    n = w.shape[0]
    lib = _build.library()
    with torch.cuda.device(w.device):
        scratch = torch.empty((2 * draw_partials(n),), dtype=torch.int32,
                              device=w.device)
        idx = torch.empty((1,), dtype=torch.int64, device=w.device)
        code = lib.kmt_weighted_draw(
            w.data_ptr(), valid.data_ptr(), u.data_ptr(), scratch.data_ptr(),
            idx.data_ptr(),
            None if row_source is None else row_source.data_ptr(),
            None if out_row is None else out_row.data_ptr(), n,
            0 if row_source is None else row_source.shape[1],
            int(row_source is not None
                and row_source.dtype == torch.bfloat16),
            scratch.numel(), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, "kmt_weighted_draw")
    LAUNCHES["weighted_draw"] += 1
    return idx


def _chain(v):
    """Running order of the draw's tree: the values along the last dim
    added left to right from 0 in fp32, (((0 + v0) + v1) + ...)."""
    c = torch.zeros(v.shape[:-1], dtype=torch.float32, device=v.device)
    for i in range(v.shape[-1]):
        c = c + v[..., i]
    return c


def _node_pick(vals, t):
    """One node of the descent: children ``vals`` (count,) fp32, summed
    left to right from 0; ``t`` (1,) fp32 is held below their total, the
    child is the first whose running sum exceeds it (the last if none
    does), and t loses the running sum before it.  Returns (child (1,)
    int64, t); no host read."""
    c = torch.zeros((1,), dtype=torch.float32, device=vals.device)
    run = []
    for i in range(vals.shape[0]):
        c = c + vals[i:i + 1]
        run.append(c)
    run = torch.cat(run)
    lim = torch.nextafter(run[-1:], torch.zeros_like(t))
    t = torch.where(t < lim, t, lim)
    # the leading children not above t; all of them: the last child
    lead = (~(run > t)).to(torch.int64).cumprod(0).sum()
    i = lead.clamp(max=run.shape[0] - 1).reshape(1)
    before = torch.where(i > 0, run[(i - 1).clamp(min=0)], 0.0)
    return i, t - before


def _chunk_leaves(leaves, P):
    """(P, 32, 32, 4): the leaves padded with zeros to whole chunks, as
    chunk, line, quad, row."""
    padded = torch.zeros((P * DRAW_CHUNK,), dtype=torch.float32,
                         device=leaves.device)
    padded[:leaves.shape[0]] = leaves
    return padded.view(P, 32, 32, 4)


def weighted_draw_reference(w, valid, u):
    """Plain twin of :func:`weighted_draw`: ``kmt_weighted_draw``'s tree
    and order (see ``csrc/draw.cu``) in plain torch, bitwise its index.
    Returns the (1,) int64 index; no host read."""
    n = w.shape[0]
    P = draw_partials(n)
    R = -(-P // DRAW_GROUPS)
    # launch 1: each chunk's quads, lines and lines' sum; its valid rows
    parts = _chain(_chain(_chain(_chunk_leaves(w, P))))
    counts = _chunk_leaves(valid.float(), P).view(P, -1).sum(1)

    def root(values):
        groups = torch.zeros((DRAW_GROUPS * R,), dtype=torch.float32,
                             device=w.device)
        groups[:P] = values
        groups = groups.view(DRAW_GROUPS, R)
        sums = _chain(groups).view(32, 32)
        supers = _chain(sums)
        return groups, sums, supers, _chain(supers)

    by_w = root(parts)
    by_valid = root(counts.float())
    # no positive weight (every valid row already chosen): the valid rows
    use_valid = ~(by_w[3] > 0)
    groups, sums, supers, total = (torch.where(use_valid, a, b)
                                   for a, b in zip(by_valid, by_w))
    t = u * total
    s, t = _node_pick(supers, t)
    g, t = _node_pick(sums.index_select(0, s)[0], t)
    g = s * 32 + g
    i, t = _node_pick(groups.index_select(0, g)[0], t)
    j = g * R + i
    leaves = torch.where(use_valid, valid.float(), w)
    chunks = _chunk_leaves(leaves, P).view(P, -1)
    chunk = torch.where(j < P, chunks.index_select(0, j.clamp(max=P - 1)),
                        0.0).view(32, 32, 4)
    quads = _chain(chunk)
    lines = _chain(quads)
    l, t = _node_pick(lines, t)
    q, t = _node_pick(quads.index_select(0, l)[0], t)
    r, t = _node_pick(chunk.index_select(0, l)[0].index_select(0, q)[0], t)
    idx = j * DRAW_CHUNK + l * 128 + q * 4 + r
    return torch.clamp(idx, max=n - 1)

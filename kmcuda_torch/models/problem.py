"""Prepared problem state: upload, storage dtype, NaN hygiene, row shards.

The port of ``kmcuda_tpu.models.problem.prepare``.  The samples are cut
into contiguous row shards, one per device of the call's
:class:`~kmcuda_torch.parallel.devices.Topology` (one shard on one
device).  Rows with any non-finite value are marked invalid once and
zeroed, so no kernel ever sees a NaN; they keep the invalid id k.  The
finite test and the squared norms run over row blocks, so no (n, f)
temporary is stored beside the samples.  fp16
and bf16 input is stored as bf16, fp32 and fp64 input as fp32.  Nothing
is padded: the kernels mask their own ragged edge, and the cut never
pads either, so the shards' rows add up to n.
"""

import dataclasses

import numpy as np
import torch

from kmcuda_torch.ops.distance import DistanceMetric, finite_rows, row_sq_norms
from kmcuda_torch.parallel.devices import Topology
from kmcuda_torch.utils.errors import KMTPUInvalidArguments


@dataclasses.dataclass
class Shard:
    """Rows [start, stop) of the samples, on one device."""

    start: int
    stop: int
    x: torch.Tensor        # (rows, F) cleaned, storage dtype
    x_sq: torch.Tensor     # (rows,) fp32 squared norms
    valid: torch.Tensor    # (rows,) bool
    assign0: torch.Tensor  # (rows,) int32 all k: 'never assigned'


@dataclasses.dataclass
class Problem:
    """Device-resident, cleaned inputs, one :class:`Shard` per device of
    ``topo``."""

    logger: object
    n: int
    features: int
    k: int
    metric: DistanceMetric
    topo: Topology
    dtype: torch.dtype    # storage dtype (float32 or bfloat16)
    shards: list
    n_valid: int
    starts: torch.Tensor  # (shards,) int64 first row of each, on the leader
    lasts: torch.Tensor   # (shards,) int64 last local row of each, ditto

    @property
    def device(self) -> torch.device:
        """The leader: where centroids and reductions live."""
        return self.topo.leader

    @property
    def xs(self) -> list:
        return [s.x for s in self.shards]

    @property
    def x_sqs(self) -> list:
        return [s.x_sq for s in self.shards]

    @property
    def valids(self) -> list:
        return [s.valid for s in self.shards]

    @property
    def assign0s(self) -> list:
        return [s.assign0 for s in self.shards]

    def _whole(self, name: str) -> torch.Tensor:
        if len(self.shards) != 1:
            raise ValueError("problem.%s of a %d-shard problem; use %ss"
                             % (name, len(self.shards), name))
        return getattr(self.shards[0], name)

    # the whole arrays of a one-shard problem
    x = property(lambda self: self._whole("x"))
    x_sq = property(lambda self: self._whole("x_sq"))
    valid = property(lambda self: self._whole("valid"))
    assign0 = property(lambda self: self._whole("assign0"))

    def per_shard(self, v) -> list:
        """Per-row values as a list over the shards: a list is taken as it
        is, a whole (n, ...) tensor is cut by the shards' rows (see
        ``parallel.devices.shaped_like`` for the way back)."""
        if not isinstance(v, torch.Tensor):
            return list(v)
        if len(self.shards) == 1:
            return [v]
        return self.topo.scatter(v, [(s.start, s.stop) for s in self.shards])

    def take(self, parts, ids) -> torch.Tensor:
        """Rows ``ids`` (global row ids, an int64 tensor) of per-shard
        ``parts``, on the leader in the order of ``ids``, with no host
        sync: every shard gathers the ids' clamped local rows, and each id
        keeps the row of the shard that holds it."""
        lead = self.device
        ids = ids.to(lead)
        if len(parts) == 1:
            return parts[0].index_select(0, ids)
        which = torch.searchsorted(self.starts, ids, right=True) - 1
        local = torch.minimum(
            torch.clamp(ids[None, :] - self.starts[:, None], min=0),
            self.lasts[:, None])
        rows = torch.stack([part.index_select(0, loc.to(part.device))
                            .to(lead) for part, loc in zip(parts, local)])
        return rows[which, torch.arange(ids.numel(), device=lead)]


def storage_dtype_for(dtype) -> torch.dtype:
    """fp16/bf16 -> bf16 storage; fp32/fp64 -> fp32."""
    if dtype in (torch.float16, torch.bfloat16):
        return torch.bfloat16
    if dtype in (torch.float32, torch.float64):
        return torch.float32
    raise KMTPUInvalidArguments(
        "samples dtype must be float16/bfloat16/float32/float64, got %s"
        % dtype)


def _as_tensor(samples) -> torch.Tensor:
    """Host array -> CPU tensor sharing its memory."""
    arr = np.ascontiguousarray(samples)
    if arr.dtype not in (np.float16, np.float32, np.float64):
        raise KMTPUInvalidArguments(
            "numpy samples must be float16/float32/float64 (bfloat16 as a "
            "torch.Tensor), got %s" % arr.dtype)
    return torch.from_numpy(arr)


def prepare(samples, k: int, metric: DistanceMetric, where, logger,
            donate: bool = False) -> Problem:
    """Cut the samples into row shards over ``where`` (a
    :class:`Topology`, or one ``torch.device``), move each to its device
    in the storage dtype and clean it.  With fewer rows than devices the
    first n devices take a row each.

    The caller's data is never written unless ``donate`` is set and
    ``samples`` is a tensor whose rows are already contiguous and in their
    storage dtype on their shard's device: then invalid rows are zeroed in
    place instead of in a copy.
    """
    topo = where if isinstance(where, Topology) else Topology([where])
    is_tensor = isinstance(samples, torch.Tensor)
    src = samples if is_tensor else _as_tensor(samples)
    n, features = src.shape
    dtype = storage_dtype_for(src.dtype)
    if n < topo.n:
        logger.info("%d samples for %d devices: running on %d shards"
                    % (n, topo.n, n))
        topo = Topology(topo.devices[:n])
    ranges = topo.split(n)
    parts = []
    for (start, stop), dev in zip(ranges, topo.devices):
        part = src[start:stop]
        x = part.to(device=dev, dtype=dtype).contiguous()
        owned = x.data_ptr() != part.data_ptr() or (is_tensor and donate)
        parts.append((x, owned, finite_rows(x)))
    n_valids = topo.read([valid.sum() for _x, _o, valid in parts])
    shards = []
    for (start, stop), (x, owned, valid), nv in zip(ranges, parts,
                                                    n_valids):
        if nv < stop - start:
            invalid = torch.logical_not(valid)[:, None]
            x = (x.masked_fill_(invalid, 0) if owned
                 else x.masked_fill(invalid, 0))
        shards.append(Shard(start, stop, x, row_sq_norms(x), valid,
                            torch.full((stop - start,), k, dtype=torch.int32,
                                       device=x.device)))
    n_valid = sum(n_valids)
    logger.debug("prepared problem: n=%d, features=%d, k=%d, dtype=%s, "
                 "device=%s%s, valid=%d"
                 % (n, features, k, str(dtype).replace("torch.", ""),
                    topo.leader, ", shards=%d" % topo.n if topo.n > 1
                    else "", n_valid))
    # the JAX package's split plan, one line per shard (one chunk each: the
    # port scans a shard in one launch), and at verbosity 3 its
    # allocation map
    itemsize = torch.empty((), dtype=dtype).element_size()
    for s in shards:
        logger.debug("plan: %s rows [%d, %d) (1 chunks, %.1f MB samples)"
                     % (s.x.device, s.start, s.stop,
                        (s.stop - s.start) * features * itemsize / 2**20))
    for name, shape, arr in (
            ("x", (n, features), shards[0].x),
            ("x_sq", (n,), shards[0].x_sq), ("valid", (n,), shards[0].valid),
            ("assign0", (n,), shards[0].assign0)):
        logger.trace("alloc %-8s %-14s %-9s %8.1f MB sharded over %d"
                     % (name, shape, str(arr.dtype).replace("torch.", ""),
                        int(np.prod(shape)) * arr.element_size() / 2**20,
                        topo.n))
    return Problem(logger=logger, n=n, features=features, k=k, metric=metric,
                   topo=topo, dtype=dtype, shards=shards, n_valid=n_valid,
                   starts=torch.tensor([s.start for s in shards],
                                       device=topo.leader),
                   lasts=torch.tensor([s.stop - s.start - 1 for s in shards],
                                      device=topo.leader))

"""Devices of a call: the bitmask, and the :class:`Topology` that shards a
call over the devices it selects.

The reference selects GPUs with a bitmask (1 = device 0, 2 = device 1,
3 = both, 0 = all).  A set bit beyond the device count raises
:class:`KMTPUNoSuchDevice`, as ``kmcuda_tpu.parallel.mesh.select_devices``
does.

A :class:`Topology` is the port of ``kmcuda_tpu.parallel.mesh.Topology``.
One process drives every device, as kmcuda's host thread does
(``FOR_EACH_DEV``): the samples are cut into contiguous row shards, one
per device; centroids and tables are replicated with ``Tensor.to`` (a peer
copy between cards, a no-op on one device); sums, counts and counters are
reduced on the leader, the first device, in shard order (shard 0 + shard 1
+ ...), so a result repeats bitwise for a given device set.  There is no
``torch.distributed``.  One device is a one-shard topology whose
reductions are the identity: every device count runs one code path.

Devices may repeat: ``Topology([torch.device("cpu")] * 8)`` is eight
logical shards on one device, the counterpart of the JAX suite's 8-device
CPU mesh.  The public mask never repeats a device.
"""

import torch

from kmcuda_torch.utils.errors import KMTPUNoSuchDevice


def select_devices(device_mask: int, logger=None) -> list:
    """Decode the mask against ``torch.cuda.device_count()``; returns the
    selected ``torch.device``s (none on a host without CUDA and mask 0)."""
    count = torch.cuda.device_count()
    if device_mask == 0:
        selected = [torch.device("cuda", i) for i in range(count)]
    else:
        selected = []
        for i in range(int(device_mask).bit_length()):
            if device_mask >> i & 1:
                if i >= count:
                    raise KMTPUNoSuchDevice(
                        "device mask %#x addresses device %d but only %d "
                        "device(s) exist" % (device_mask, i, count))
                selected.append(torch.device("cuda", i))
    if logger is not None:
        logger.debug("devices: %s" % ", ".join(str(d) for d in selected))
    return selected


def as_shards(v) -> list:
    """A tensor (one shard) or a sequence of per-shard tensors, as a list."""
    return [v] if isinstance(v, torch.Tensor) else list(v)


def gather(parts, device) -> torch.Tensor:
    """Per-shard row blocks joined on ``device`` in shard order (one part
    is moved, not copied, so on its own device it comes back as is)."""
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts])


def shaped_like(ref, parts):
    """Per-shard ``parts`` in the form of ``ref``: a list for a list, else
    one tensor on ``ref``'s device."""
    if isinstance(ref, torch.Tensor):
        return gather(parts, ref.device)
    return list(parts)


class Topology:
    """The devices a call runs on, one row shard each; the first leads."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise KMTPUNoSuchDevice("a topology needs at least one device")
        self.n = len(self.devices)
        self.leader = self.devices[0]

    @classmethod
    def from_device_mask(cls, device_mask: int, logger=None) -> "Topology":
        """The CUDA devices the mask selects (0 = all); none raises."""
        selected = select_devices(device_mask, logger)
        if not selected:
            raise KMTPUNoSuchDevice(
                "no CUDA device exists; pass a torch.Tensor to run on its "
                "own device")
        return cls(selected)

    @classmethod
    def of(cls, parts) -> "Topology":
        """The topology of per-shard tensors: one shard per part, on its
        device."""
        return cls([p.device for p in parts])

    def split(self, n: int) -> list:
        """Contiguous ranges [(start, stop), ...] that cut ``n`` >= 1 rows
        into one shard per device, the first ``n % d`` one row longer; with
        fewer rows than devices, one row for each of the first ``n``."""
        d = min(self.n, int(n))
        base, extra = divmod(int(n), d)
        out, start = [], 0
        for i in range(d):
            stop = start + base + (i < extra)
            out.append((start, stop))
            start = stop
        return out

    def scatter(self, t: torch.Tensor, ranges) -> list:
        """Rows of ``t`` cut by ``ranges`` (from :meth:`split`), each moved
        to its shard's device."""
        return [t[a:b].to(dev) for (a, b), dev in zip(ranges, self.devices)]

    def gather(self, parts, device=None) -> torch.Tensor:
        """Per-shard rows joined in shard order on ``device`` (the leader
        by default)."""
        return gather(parts, self.leader if device is None else device)

    def reduce(self, parts) -> torch.Tensor:
        """Sum of per-shard tensors on the leader, added in shard order:
        ((p0 + p1) + p2) + ...; one part is returned as it is."""
        acc = parts[0].to(self.leader)
        for p in parts[1:]:
            acc = acc + p.to(self.leader)
        return acc

    def broadcast(self, t: torch.Tensor) -> list:
        """``t`` on every shard's device, in shard order."""
        return [t.to(d) for d in self.devices]

    def read(self, scalars) -> list:
        """Host ints of device scalars (any devices): stacked on the leader
        and read with one host sync."""
        return torch.stack([s.to(self.leader).reshape(())
                            for s in scalars]).tolist()

    def distinct(self) -> list:
        """The devices without repeats, in shard order."""
        return list(dict.fromkeys(self.devices))

    def synchronize(self) -> None:
        for d in self.distinct():
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def memory_report(self) -> list:
        """One memory line per distinct device, as ``kmcuda_tpu.parallel.
        mesh.Topology.memory_report`` prints at verbosity 2: torch's
        caching allocator on a CUDA device, ``memory stats n/a``
        elsewhere."""
        return [_memory_line(d) for d in self.distinct()]


def topology_for(samples, device_mask: int, logger=None) -> Topology:
    """The devices a call runs on, with no fallback.

    A tensor runs on its own device, as one shard, unless the mask selects
    several devices: then it is scattered over them (its results come
    back on its own device).  Mask 0 with a tensor is its own device.
    Anything else runs on the CUDA devices the mask selects (0 = all)."""
    if not isinstance(samples, torch.Tensor):
        return Topology.from_device_mask(device_mask, logger)
    selected = select_devices(device_mask, logger)
    if device_mask == 0 or len(selected) < 2:
        return Topology([samples.device])
    return Topology(selected)


def _memory_line(device: torch.device) -> str:
    if device.type != "cuda":
        return "%s: memory stats n/a" % (device,)
    mb = 2**20
    return ("%s: %.0f MB in use / %.0f MB limit (peak %.0f MB, %.0f MB "
            "reserved)" % (device, torch.cuda.memory_allocated(device) / mb,
                           torch.cuda.get_device_properties(
                               device).total_memory / mb,
                           torch.cuda.max_memory_allocated(device) / mb,
                           torch.cuda.memory_reserved(device) / mb))

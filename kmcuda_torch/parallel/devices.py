"""Device bitmask decoding over the CUDA devices torch sees.

The reference selects GPUs with a bitmask (1 = device 0, 2 = device 1,
3 = both, 0 = all).  A set bit beyond the device count raises
:class:`KMTPUNoSuchDevice`, as ``kmcuda_tpu.parallel.mesh.select_devices``
does.  Only one device runs a call so far: a mask that selects more raises
``NotImplementedError`` (multi-device is ROADMAP §A7).
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


def device_for(samples, device_mask: int, logger=None) -> torch.device:
    """The one device a call runs on, with no fallback.

    A tensor runs on its own device; the mask is still checked, and one
    that names several devices raises.  Anything else runs on the CUDA
    device the mask selects (mask 0 = all, so it must be a 1-GPU host)."""
    selected = select_devices(device_mask, logger)
    tensor = isinstance(samples, torch.Tensor)
    if len(selected) > 1 and not (tensor and device_mask == 0):
        raise NotImplementedError(
            "device mask %#x selects %d devices; multi-device runs are not "
            "ported yet (ROADMAP §A7)" % (device_mask, len(selected)))
    if tensor:
        return samples.device
    if not selected:
        raise KMTPUNoSuchDevice(
            "no CUDA device exists; pass a torch.Tensor to run on its own "
            "device")
    return selected[0]


def memory_report(device: torch.device) -> list:
    """The device's memory line, as ``kmcuda_tpu.parallel.mesh.Topology.
    memory_report`` prints one per device at verbosity 2: torch's caching
    allocator on a CUDA device, ``memory stats n/a`` elsewhere."""
    if device.type != "cuda":
        return ["%s: memory stats n/a" % (device,)]
    mb = 2**20
    return ["%s: %.0f MB in use / %.0f MB limit (peak %.0f MB, %.0f MB "
            "reserved)" % (device, torch.cuda.memory_allocated(device) / mb,
                           torch.cuda.get_device_properties(
                               device).total_memory / mb,
                           torch.cuda.max_memory_allocated(device) / mb,
                           torch.cuda.memory_reserved(device) / mb)]

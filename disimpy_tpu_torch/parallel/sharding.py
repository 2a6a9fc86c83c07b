"""Splitting spins over several CUDA devices.

Spins are independent, and every random draw is keyed by the spin's global
id (``engine/krng.py``), so a run split into contiguous parts, each on its
own device with its ids offset by the part's first spin, walks every spin
exactly as a single run does. Each part gets its own copy of the substrate
spec; the parts run concurrently, one host thread per part (the classic
engine syncs the host once per bounce pass, so parts run one after another
would serialize), and simulation() reduces the signals on the host. No part
is padded: parts may differ in size. A fused part on a CUDA device replays
a CUDA graph of its own, with its own memory pool and static buffers (the
graph cache in ``engine/fused.py`` keys each part by its first spin, and
captures one at a time, thread-locally).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import torch


def _device(d):
    """A torch.device with an explicit index for CUDA devices."""
    try:
        d = torch.device(d)
    except (RuntimeError, TypeError) as e:
        raise ValueError(f"Incorrect value ({d!r}) for devices") from e
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise ValueError(f"device {d} asked for, but torch finds no CUDA "
                             "GPU")
        index = torch.cuda.current_device() if d.index is None else d.index
        if index >= torch.cuda.device_count():
            raise ValueError(f"device {d} asked for, but only "
                             f"{torch.cuda.device_count()} CUDA devices exist")
        return torch.device("cuda", index)
    if d.type != "cpu":
        raise ValueError(f"Incorrect value ({d!r}) for devices: the port runs "
                         "on cuda or cpu")
    return d


def resolve_devices(devices, device=None):
    """The list of devices a run's parts go to.

    ``devices`` is None (one part on ``device``, "cuda" when that is None
    too), an int k (the first k CUDA devices; raises if fewer exist) or a
    sequence of devices or device strings (exactly those, repeats
    allowed). A ``device`` given beside ``devices`` must name the same
    device as every entry.
    """
    if devices is None:
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch finds no CUDA GPU; pass "
                "device='cpu' to run the plain-torch engine on the CPU")
        return [device]
    if isinstance(devices, bool):
        raise ValueError(f"Incorrect value ({devices}) for devices")
    if isinstance(devices, int):
        if devices < 1:
            raise ValueError(f"Incorrect value ({devices}) for devices")
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if devices > have:
            raise ValueError(f"devices={devices} asks for {devices} CUDA "
                             f"devices, but {have} exist")
        out = [torch.device("cuda", i) for i in range(devices)]
    elif isinstance(devices, (str, torch.device)):
        out = [_device(devices)]
    else:
        try:
            out = [_device(d) for d in devices]
        except TypeError as e:
            raise ValueError(f"Incorrect value ({devices!r}) for devices") from e
        if not out:
            raise ValueError("devices must name at least one device")
    if device is not None:
        want = _device(device)
        if any(d != want for d in out):
            raise ValueError(f"device={device!r} conflicts with "
                             f"devices={devices!r}")
    return out


def split_ranges(n, n_parts):
    """Contiguous ``(lo, hi)`` spin ranges of ``n_parts`` parts of ``n``
    spins, sizes differing by at most one (a part may be empty when
    ``n < n_parts``)."""
    base, extra = divmod(n, n_parts)
    ranges, lo = [], 0
    for k in range(n_parts):
        hi = lo + base + (k < extra)
        ranges.append((lo, hi))
        lo = hi
    return ranges


def spec_to(spec, device):
    """A copy of a spec dataclass with every tensor field on ``device``
    (the spec itself when it is already there)."""
    moved = {
        f.name: getattr(spec, f.name).to(device)
        for f in dataclasses.fields(spec)
        if isinstance(getattr(spec, f.name), torch.Tensor)
    }
    if all(t is getattr(spec, k) for k, t in moved.items()):
        return spec
    return dataclasses.replace(spec, **moved)


def run_parts(fn, parts):
    """``[fn(*part) for part in parts]``, one host thread per part when
    there are several. A part that raises fails the run."""
    if len(parts) == 1:
        return [fn(*parts[0])]
    with ThreadPoolExecutor(len(parts)) as pool:
        futures = [pool.submit(fn, *part) for part in parts]
        return [f.result() for f in futures]

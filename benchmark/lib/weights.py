"""Seeded weights, made by the benchmark and handed to the program and the
reference alike.

Every parameter of the configured network is a convolution's weight or
bias, drawn as torch's default conv init draws it, U(±1/√fan_in) with the
weight's fan-in for both. One U(−1, 1) draw of all of them on the device
from a ``torch.Generator`` seeded with the run's seed, times one vector of
bounds: two large calls, in fp32, the type the parameters are kept in.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.reference.model import Arch, TCStereo


def specs(arch: Arch) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, bound) of every parameter, in the network's order."""
    with torch.device("meta"):
        net = TCStereo(arch)
    out, fan_of = [], {}
    for name, p in net.named_parameters():
        owner = name.rsplit(".", 1)[0]
        if name.endswith(".weight"):
            fan_in = p.shape[1] * p[0][0].numel()
            fan_of[owner] = fan_in
        else:
            fan_in = fan_of[owner]
        out.append((name, tuple(p.shape), fan_in ** -0.5))
    return out


def make(arch: Arch, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict drawn from ``seed`` on ``device``."""
    sp = specs(arch)
    sizes = [int(torch.Size(s).numel()) for _, s, _ in sp]
    bounds = torch.tensor([b for _, _, b in sp], dtype=torch.float32, device=device)
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=g, device=device).mul_(2.0).sub_(1.0)
    flat.mul_(torch.repeat_interleave(bounds, torch.tensor(sizes, device=device)))
    return {name: t.view(shape) for (name, shape, _), t in zip(sp, flat.split(sizes))}

"""The one traffic generator: a mix file's parameters -> the states a
run's steps start from, made on the device from the seed.

A mix names ``initial_states`` seeded states and ``episode_steps``: the
run restarts from the next state of a seeded order every
``episode_steps`` steps (1: every step solves from a fresh state), so the
work of a step does not drift with the window's length as the transient
decays.  Each state is a sum over the mix's ``waves`` (kx, ky) of

    a sin(pi kx x / Lx + p) sin(pi ky y / Ly + q),

Lx, Ly the domain's extents, with amplitudes a ~ N(0, 1 / len(waves)) and
phases p, q ~ U(0, 2 pi) drawn for each state: every seed gets the same
waves, in other amplitudes and phases.  Values are set at each child's
nodes, in the (U, C, 3) layout, in the run's dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def initial_states(coords: np.ndarray, mix: dict, seed: int, device,
                   dtype: torch.dtype) -> torch.Tensor:
    """(initial_states, U, C, 3) states on ``device`` from child node
    coordinates (U, C, 2, 3), drawn with a generator on that device."""
    g = generator(seed, device)
    waves = torch.as_tensor(mix["waves"], dtype=torch.float64,
                            device=device)                 # (W, 2)
    n, W = int(mix["initial_states"]), len(mix["waves"])
    amp = torch.randn((n, W), generator=g, device=device,
                      dtype=torch.float64) / math.sqrt(W)
    phase = 2 * math.pi * torch.rand((n, W, 2), generator=g, device=device,
                                     dtype=torch.float64)
    xy = torch.as_tensor(coords, device=device)           # (U, C, 2, 3)
    lo = xy.amin(dim=(0, 1, 3))
    ext = xy.amax(dim=(0, 1, 3)) - lo
    s = (xy - lo[:, None]) / ext[:, None]                  # in [0, 1]
    x, y = s[:, :, 0], s[:, :, 1]                          # (U, C, 3)
    out = torch.zeros((n,) + tuple(x.shape), dtype=torch.float64,
                      device=device)
    for w in range(W):
        kx, ky = waves[w]
        fx = torch.sin(math.pi * kx * x[None] + phase[:, w, 0, None, None,
                                                         None])
        fy = torch.sin(math.pi * ky * y[None] + phase[:, w, 1, None, None,
                                                         None])
        out += amp[:, w, None, None, None] * fx * fy
    return out.to(dtype)


def episode_order(seed: int, n: int, device) -> list:
    """The seeded order in which episodes take the n initial states."""
    g = generator(seed + 1, device)
    return torch.randperm(n, generator=g, device=device).tolist()

"""Checkpoint / resume for long transport runs (copy of the JAX package's
``io/checkpoint.py``, in the same ``.npz`` format, so a file either package
writes resumes in the other: tests/test_torch_io.py).

The reference persists nothing restartable (only the VTU time series).
Here the solver state (the tracer field T in the standard (U, C, 3)
layout, as numpy), the step counter and the config (``meta`` JSON, with
``str()`` of non-primitive fields) round-trip through a single .npz file;
time loops resume exactly.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np


def save(path: str, T, step: int, cfg=None, extra: dict | None = None
         ) -> None:
    meta = {"step": int(step)}
    if cfg is not None:
        meta["cfg"] = {
            k: (v if isinstance(v, (int, float, str, bool, list, tuple))
                else str(v))
            for k, v in dataclasses.asdict(cfg).items()}
    np.savez(path, T=np.asarray(T), meta=json.dumps(meta),
             **(extra or {}))


def load(path: str):
    """Returns (T, step, meta_dict, extras)."""
    with np.load(path, allow_pickle=False) as z:
        T = z["T"]
        meta = json.loads(str(z["meta"]))
        extras = {k: z[k] for k in z.files if k not in ("T", "meta")}
    return T, meta["step"], meta, extras


def run_with_checkpoints(solver, T, ntime: int, path: str | None,
                         every: int = 10, start_step: int = 0,
                         observe=None):
    """Time-step T (the standard (U, C, 3) layout, after start_step steps)
    to step ntime with ``solver.stepper()``, saving to ``path`` every
    ``every`` steps and at the last (no file when path is None); resumable
    via load().  The state stays in the step's layout between steps: it is
    converted (on the card, copied to the host) only for a file written.
    ``observe(k, S, stepper)``, when given, sees the state S after k steps,
    for k = start_step, ..., ntime.  Returns T after ntime steps."""
    from ..convert import state_to_numpy

    st = solver.stepper()
    S = st.to_state(T)
    if observe is not None:
        observe(start_step, S, st)
    for step in range(start_step, ntime):
        S = st.step(S)
        if observe is not None:
            observe(step + 1, S, st)
        if path and ((step + 1) % every == 0 or step + 1 == ntime):
            save(path, state_to_numpy(st.from_state(S)), step + 1,
                 solver.cfg)
    return st.from_state(S)

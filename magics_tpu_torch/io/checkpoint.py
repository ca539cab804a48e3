"""Checkpoint / resume of the dense simulation state (counterpart of
magics_tpu's io/checkpoint.py).

The reference has no real checkpointing — its nearest equivalents are
scenario hot-reload (simulation_loader.rs:687-713) and the JSON export
snapshot (export.rs). With the whole simulation as one set of dense
tensors, checkpointing is a single npz write; `save` captures every SimState
field, `load` restores it bit-exactly, so a resumed run continues
deterministically.

The format is magics_tpu's (version 1, the same `_FIELD_DEFAULTS`), so a
checkpoint written by either package loads in the other:

* The port's state has no `rng` leaf (its comms-failure draws come from a
  `torch.Generator`). `save` writes the generator's state, the bytes of
  `Generator.get_state()`, under `GENERATOR_KEY`, and `load(generator=...)`
  restores it. The JAX package ignores that key.
* The JAX package's `load` needs an `rng` key, so `save` writes the JAX PRNG
  key of the run's seed (`jax_prng_key(meta["seed"])`, what
  `jax.random.PRNGKey` gives). A JAX checkpoint's `rng` is dropped on load.

Compatibility: fields added to SimState after a checkpoint was written are
restored from `_FIELD_DEFAULTS` (keyed on field name, given the robot count
R from the checkpoint), so old checkpoints keep loading. The collision
hysteresis layout depends on grid mode ([R, R] overlap matrix dense vs
[R, P] partner table grid) — `save` records the mode in metadata and `load`
raises a clear error when resuming under mismatched params.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from magics_tpu_torch.graph.state import GbpParams, SimState, require_device

_FORMAT_VERSION = 1

# Defaults for fields that may be absent in older checkpoints:
# name -> ((R, data) -> np.ndarray), where `data` is the open npz archive.
# Keep entries forever; never remove.
_FIELD_DEFAULTS = {
    # reciprocal-slot cache: recomputed from nbr_idx/nbr_mask by
    # _finish_connectivity every tick before any consumer reads it, so
    # zeros are safe for pre-cache checkpoints
    "nbr_back": lambda R, data: np.zeros(
        data["ir_int_seeded"].shape[:2], dtype=np.int32
    ),
    "nbr_has_back": lambda R, data: np.zeros(
        data["ir_int_seeded"].shape[:2], dtype=bool
    ),
    "nbr_overflow": lambda R, data: np.asarray(0, dtype=np.int32),
    "grid_overflow": lambda R, data: np.asarray(0, dtype=np.int32),
    # pre-mission-manager checkpoints had no in-flight planning: no robot
    # can be awaiting a plan
    "plan_pending": lambda R, data: np.zeros(R, dtype=bool),
    "rr_partner": lambda R, data: np.zeros((R, 0), dtype=np.int32),
    "rr_partner_overflow": lambda R, data: np.asarray(0, dtype=np.int32),
    "vel_log": lambda R, data: np.full_like(data["pos_log"], np.nan),
    "viz_mean": lambda R, data: np.zeros(
        (0, R, data["prior_mean"].shape[1], 2), dtype=np.float32
    ),
    "viz_cov": lambda R, data: np.zeros(
        (0, R, data["prior_mean"].shape[1], 3), dtype=np.float32
    ),
    "viz_trk": lambda R, data: np.zeros(
        (0, R, max(data["prior_mean"].shape[1] - 2, 0), 2), dtype=np.float32
    ),
    # compact rank-1 inter-robot messages (state.py): derived losslessly from
    # the dense fields of pre-compaction checkpoints via the gauge
    # (gx, gy, t, s) ~ (1, lam01/lam00, eta0, lam00) (or the y-axis analogue)
    "ir_v2f_ext_pos": lambda R, data: np.asarray(
        data["ir_v2f_ext_mu"][..., :2]
        if "ir_v2f_ext_mu" in data.files
        else np.zeros((R,) + data["ir_int_seeded"].shape[1:] + (2,)),
        dtype=data["prior_mean"].dtype,
    ),
    "ir_f2v_ext": lambda R, data: _compact_rank1(
        data, "ir_f2v_ext_eta", "ir_f2v_ext_lam"
    ),
    "ext_inbox": lambda R, data: _compact_rank1(
        data, "ext_inbox_eta", "ext_inbox_lam"
    ),
}


def _compact_rank1(data, eta_key: str, lam_key: str) -> np.ndarray:
    """Old dense (eta [..., 4], lam [..., 4, 4]) -> compact (gx, gy, t, s)."""
    if eta_key not in data.files:
        base = data["ir_int_seeded"].shape  # [R, K, V-1]
        return np.zeros(base + (4,), dtype=data["prior_mean"].dtype)
    eta = np.asarray(data[eta_key])
    lam = np.asarray(data[lam_key])
    l00, l01, l11 = lam[..., 0, 0], lam[..., 0, 1], lam[..., 1, 1]
    use_x = np.abs(l00) > 0
    safe00 = np.where(use_x, l00, 1.0)
    gx = np.where(use_x, 1.0, 0.0)
    gy = np.where(use_x, l01 / safe00, np.where(np.abs(l11) > 0, 1.0, 0.0))
    t = np.where(use_x, eta[..., 0], eta[..., 1])
    s = np.where(use_x, l00, l11)
    return np.stack([gx, gy, t, s], axis=-1).astype(eta.dtype)


#: npz key of the comms-failure generator's state (uint8 bytes)
GENERATOR_KEY = "torch_generator_state"


def jax_prng_key(seed: int) -> np.ndarray:
    """The raw uint32 [2] key `jax.random.PRNGKey(seed)` makes (threefry)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], dtype=np.uint32)


def save(
    path: str | Path,
    state: SimState,
    *,
    params: GbpParams | None = None,
    meta: dict | None = None,
    generator: torch.Generator | None = None,
) -> None:
    """Write the full SimState, the generator's state where given, and
    optional JSON-able metadata to npz."""
    arrays = {
        f.name: getattr(state, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(state)
    }
    # magics_tpu's SimState leaf that the port does not carry; its loader
    # needs one
    arrays["rng"] = jax_prng_key((meta or {}).get("seed") or 0)
    if generator is not None:
        arrays[GENERATOR_KEY] = generator.get_state().numpy()
    header: dict = {"version": _FORMAT_VERSION, **(meta or {})}
    if params is not None:
        header["use_grid"] = bool(params.use_grid)
        header["collision_partners"] = int(params.collision_partners)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8
    )
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **arrays)


def load(
    path: str | Path,
    *,
    params: GbpParams | None = None,
    device: torch.device | str = "cuda",
    generator: torch.Generator | None = None,
) -> tuple[SimState, dict]:
    """Read (state, meta) back, the state on `device` (the card unless the
    caller asks for the CPU). Arrays are restored with their saved dtypes;
    fields missing from older checkpoints take `_FIELD_DEFAULTS`; a JAX
    checkpoint's `rng` is dropped. Where `generator` is given and the
    checkpoint holds a generator state, the generator is set to it. Pass
    `params` to validate that the checkpoint's collision-grid mode matches
    the params it will resume under (a mismatch silently corrupts the
    hysteresis tables otherwise)."""
    device = require_device(device)
    with np.load(Path(path)) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        if meta.get("version") != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version: {meta.get('version')}")
        R = int(data["active"].shape[0])
        kwargs = {}
        for f in dataclasses.fields(SimState):
            if f.name in data.files:
                kwargs[f.name] = torch.as_tensor(data[f.name], device=device)
            elif f.name in _FIELD_DEFAULTS:
                kwargs[f.name] = torch.as_tensor(
                    _FIELD_DEFAULTS[f.name](R, data), device=device
                )
            else:
                raise KeyError(
                    f"checkpoint {path} lacks SimState field {f.name!r} and no "
                    "compatibility default is registered"
                )
        if generator is not None and GENERATOR_KEY in data.files:
            generator.set_state(torch.from_numpy(np.array(data[GENERATOR_KEY])))
    state = SimState(**kwargs)
    if params is not None:
        ckpt_grid = meta.get("use_grid")
        if ckpt_grid is None:
            # legacy checkpoint without recorded mode: infer from shapes
            ckpt_grid = state.rr_overlap.shape[1] == 0 and R > 0
        if bool(ckpt_grid) != params.use_grid:
            raise ValueError(
                f"checkpoint was written in {'grid' if ckpt_grid else 'dense'} "
                f"collision mode but params request "
                f"{'grid' if params.use_grid else 'dense'} — resume under the "
                "original mode (grid_cell_size setting)"
            )
        if params.use_grid and state.rr_partner.shape[1] != params.collision_partners:
            raise ValueError(
                f"checkpoint partner-table width {state.rr_partner.shape[1]} != "
                f"params.collision_partners {params.collision_partners}"
            )
    return state, meta

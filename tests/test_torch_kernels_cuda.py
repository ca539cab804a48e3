"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU (Hopper, sm_90a) and skips where
`torch.cuda.is_available()` is false; run them on the card with

    python -m pytest tests/test_torch_kernels_cuda.py -q

Inputs: a small converging crossing (R=37, so the robot edge is ragged
against the kernels' 8-robot tiles and warp-sized blocks) after a few plain
ticks; the internal slot samples a non-trivial SDF itself, with a third of
its obstacle linearisation points on pixel edges, and is held against its
fused plain version (the SDF taps, then the reference); for tracking also a
multi-segment corner route; for the inter-robot message table the crossing
in "sender" mode and a synthetic input at the bench shapes; chains long
enough to force both slot kernels' smaller robot tiles, and the
crossing's slot inputs repeated over a V=21 chain and R=1024 (or a ragged
1021) robots for the variable slot at the bench shape; the row gather at
the bench widths and at row widths from a few words to many warps' worth,
for each word size. Tolerance: each
vector or matrix of each field within RTOL of its own scale
(`gbp_slot.scaled_error`; float32 roundoff in another summation order,
chip_smoke.py states why); for the message table, whose kernel repeats its
plain version's float order, no zero-pattern flip and IR_RTOL of each
message's scale (chip_smoke.py's); the row gather bit for bit; the
external sums (kernels/ext_sum.py) within float32 summation roundoff of
each entry's terms, and bit for bit below 64 slots, where the kernel sums
in the order of PyTorch's CUDA reduction; the compact exchange's two
kernels (K5, kernels/compact_exchange.py) bit for bit at the bench, a
ragged, the Circle's and the scale shapes, on a crossing's inputs, and
over 12 ticks of the kernels' path against K5's plain versions; the
sender exchange's selects inside the message table and the row gather
bit for bit against the `where`s they replace, on the bench state after
100 sender ticks and old rows holding NaNs, and one captured swarm tick
with four operations fewer a slot than with the selects outside.

Chunks captured as CUDA graphs (graph/chunk.py) are held bit for bit
against the eager ticks on the crossing, dense and grid, under all three
exchanges, and with comms failure drawn from a registered generator; the
four kernels also run at the swarm-scale shapes of
magics_tpu_torch/bench/scale.py (R=16384, K=24, V=21).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import torch

from magics_tpu_torch.core.timesteps import device_timesteps
from magics_tpu_torch.graph import exchange as EX
from magics_tpu_torch.graph import factors as F
from magics_tpu_torch.graph import tick as T
from magics_tpu_torch.kernels import compact_exchange as CX
from magics_tpu_torch.kernels import ext_sum as E
from magics_tpu_torch.kernels import gbp_slot as G
from magics_tpu_torch.kernels import hot as HOT
from magics_tpu_torch.kernels import ir_slot as IR
from magics_tpu_torch.kernels import layout as L
from magics_tpu_torch.sim.builder import ScheduleKind, build_scenario, circle_formation

pytestmark = pytest.mark.cuda

RTOL = 1e-4
IR_RTOL = 2e-5


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def crossing(device, exchange="receiver_compact", **kw):
    """A converging 37-robot crossing, float32, on the plain passes unless
    `kw` says otherwise: (params, state, sdf)."""
    specs = circle_formation(37, circle_radius=30.0, target_speed=15.0)
    for i, s in enumerate(specs):
        s.start[:2] *= 1.0 + 0.01 * i
        s.waypoints[0, :2] *= 1.0 + 0.01 * i
    return build_scenario(
        specs, target_speed=15.0, planning_horizon=3.0, hz=10.0, comms_radius=20.0,
        internal=4, external=2, schedule=ScheduleKind.INTERLEAVE_EVENLY, n_slots=8,
        world=(200.0, 200.0), sdf=np.ones((64, 64)), dtype=torch.float32,
        device=device, ext_exchange=exchange, **{"use_pallas": False, **kw},
    )


def make_slot_inputs(device):
    """Hot slot inputs of a 37-robot crossing after 12 plain ticks, the slot
    parameters, the SDF and the world size. Every third robot's obstacle
    linearisation points sit on pixel edges of the SDF."""
    params, state, sdf = crossing(device)
    state = T.run_ticks(state, sdf, params, 12)
    y, x = np.mgrid[0:64, 0:64] / 64
    sdf_obs = torch.as_tensor(
        np.round((0.5 + 0.5 * np.sin(9 * x) * np.cos(7 * y)) * 255) / 255,
        device=device, dtype=torch.float32,
    )
    world = (params.world_width, params.world_height)
    sp = replace(
        HOT.slot_params(params), obstacle_delta=F.obstacle_delta((64, 64), world)
    )
    h = HOT.to_hot(state, params)
    edge = np.arange(1, 64)
    rng = np.random.default_rng(5)
    V2, R = h["obs_v2f_mu"].shape[1:]
    x = np.float32(rng.choice(edge, (V2, R)) * world[0] / 64 - world[0] / 2.0)
    y = np.float32(world[1] / 2.0 - rng.choice(edge, (V2, R)) * world[1] / 64)
    h["obs_v2f_mu"][0, :, ::3] = torch.as_tensor(x[:, ::3], device=device)
    h["obs_v2f_mu"][1, :, ::3] = torch.as_tensor(y[:, ::3], device=device)
    gate = (state.active & (state.mission_active | state.completed)).float()[None]
    gate[0, ::5] = 0.0  # some robots gated off
    ext = HOT._ext_sum_hot(state)
    slot_in = {
        **h, "gate": gate.contiguous(), "tgate": gate.contiguous(),
        "ext_sum_eta": ext[0], "ext_sum_lam": ext[1],
    }
    return slot_in, sp, sdf_obs, world


@pytest.fixture(scope="module")
def slot_inputs(device):
    return make_slot_inputs(device)


# the final-approach geometry of tests/test_tracking_corner.py: a long
# segment into a corner, then a 3.3 m final segment, shorter than the
# switch padding of 5.0
CORNER_PATH = [(89.4, 52.56), (103.99, 52.25), (106.25, 49.875)]


def corner_route(slot_in: dict, sp, sdf, world, seed: int = 0):
    """The slot inputs moved onto a multi-segment corner route (W=4):
    tracking variables scattered around the corner, records -1..2 (so the
    previous-segment blend, the capped windows and record advance all run),
    some factors timed out, and some routes done (2 points) or degenerate
    (1 point)."""
    rng = np.random.default_rng(seed)
    dev = slot_in["gate"].device
    V2, R = slot_in["trk_record"].shape
    W = 4
    path = np.zeros((W, R, 2))
    path[:3] = np.asarray(CORNER_PATH)[:, None]
    plen = np.full(R, 3)
    plen[1::7], plen[2::7] = 2, 1
    xy = rng.uniform([88.0, 47.0], [108.0, 55.0], size=(V2, R, 2))
    mu = np.concatenate([xy, rng.normal(scale=3.0, size=(V2, R, 2))], axis=-1)

    def f32(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32, device=dev)

    def i32(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.int32, device=dev)

    h = {
        **slot_in,
        "path_x": f32(path[..., 0]), "path_y": f32(path[..., 1]),
        "path_len": i32(plen[None]),
        "trk_v2f_mu": f32(np.moveaxis(mu, -1, 0)),
        "trk_record": i32(rng.integers(-1, 3, size=(V2, R))),
        "trk_timeout": i32(rng.choice([-1, -1, -1, 0, 2], size=(V2, R))),
    }
    sp = replace(
        sp, max_waypoints=W, switch_padding=5.0, attraction_distance=2.0,
        tracking_enabled=True,
    )
    return h, sp, sdf, world


def _assert_close(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    errs = {}
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if g.dtype == torch.int32:
            assert torch.equal(g, w), name
            continue
        assert bool(torch.isfinite(g).all()), name
        errs[name] = G.scaled_error(name, g, want)
    assert max(errs.values()) <= RTOL, errs


@pytest.mark.parametrize("tracking", [True, False])
def test_internal_slot_kernel_matches_plain(slot_inputs, tracking):
    """The kernel, SDF in, against its fused plain version on an obstacle
    SDF (messages from every obstacle factor, taps on pixel edges)."""
    slot_in, sp, sdf, world = slot_inputs
    sp = replace(sp, tracking_enabled=tracking)
    before = G.launch_counts["internal_slot"]
    got = G.internal_slot(slot_in, sdf, world, sp)
    torch.cuda.synchronize()
    assert G.launch_counts["internal_slot"] == before + 1
    want = G.internal_slot_fused_reference(slot_in, sdf, world, sp)
    _assert_close(got, want)
    assert float(want["obs_f2v_lam"].abs().max()) > 0.0
    # outputs are fresh buffers, never the inputs
    assert all(got[n].data_ptr() != slot_in[n].data_ptr() for n in got)


def longer_chain(slot_in: dict, sp, copies: int):
    """The slot inputs of a chain `copies` times as long: each variable, and
    each dynamic or interior factor, takes the data of its place in the
    original chain (the dynamic factors joining two copies that of its last
    one, the interior factors on a copy's end variables those of its first
    and last), so all but the joins compute what the original's do."""
    return chain_of(slot_in, sp, copies * sp.n_vars)


def chain_of(slot_in: dict, sp, V: int):
    """The slot inputs on a chain of V variables, each variable and factor
    taking the data of its place modulo the original chain (longer_chain)."""
    V0 = sp.n_vars
    at = {
        "var": np.arange(V) % V0,
        "dyn": np.minimum(np.arange(V - 1) % V0, V0 - 2),
        "int": np.clip((np.arange(V - 2) + 1) % V0 - 1, 0, V0 - 3),
    }
    kind = {**{n: "var" for n in ("belief_eta", "belief_lam", "belief_mean", "prior_mean",
                                  "prior_sigma", "ext_sum_eta", "ext_sum_lam")},
            **{n: "dyn" for n in G._KERNEL_IN_FIELDS if n == "delta_t" or n.startswith("dyn_")},
            **{n: "int" for n in G._KERNEL_IN_FIELDS if n.startswith(("obs_", "trk_"))}}
    out = {}
    for name in G._KERNEL_IN_FIELDS:
        x = slot_in[name]
        if name in kind:
            idx = torch.as_tensor(at[kind[name]], device=x.device)
            x = x.index_select(x.ndim - 2, idx).contiguous()
        out[name] = x
    return out, replace(sp, n_vars=V)


def swarm_of(h: dict, R: int) -> dict:
    """The fields of `h` for R robots, robot r taking the data of robot r
    modulo the original swarm."""
    R0 = h["gate"].shape[-1]
    idx = torch.arange(R, device=h["gate"].device) % R0
    return {n: x.index_select(x.ndim - 1, idx).contiguous() for n, x in h.items()}


@pytest.mark.parametrize("min_vars, tile", [(105, 4), (209, 2), (416, 1)])
def test_internal_slot_kernel_smaller_tiles(slot_inputs, min_vars, tile):
    """Chains whose 8-robot tiles do not fit in shared memory take 4-, 2- and
    1-robot tiles and several passes over the chain a block: the crossing's
    chain made at least `min_vars` long, the kernel against its fused plain
    version."""
    slot_in, sp, sdf, world = slot_inputs
    h, sp = longer_chain(slot_in, sp, -(-min_vars // sp.n_vars))
    assert G._lib().gbp_internal_tile(sp.n_vars) == tile
    got = G.internal_slot(h, sdf, world, sp)
    torch.cuda.synchronize()
    _assert_close(got, G.internal_slot_fused_reference(h, sdf, world, sp))


def test_internal_slot_kernel_corner_route(slot_inputs):
    """Tracking on the corner route: the blend with the previous segment,
    the windows capped at half a segment, record advance and timeouts."""
    h, sp, sdf, world = corner_route(*slot_inputs)
    got = G.internal_slot(h, sdf, world, sp)
    torch.cuda.synchronize()
    want = G.internal_slot_fused_reference(h, sdf, world, sp)
    _assert_close(got, want)
    assert bool((want["trk_record"] > h["trk_record"].clamp(min=0)).any())  # records advanced


def test_variable_slot_kernel_matches_plain(slot_inputs):
    slot_in, sp, _, _ = slot_inputs
    var_in = {n: slot_in[n] for n in G._VAR_IN_FIELDS}
    before = G.launch_counts["variable_slot"]
    got = G.variable_slot(var_in, sp)
    torch.cuda.synchronize()
    assert G.launch_counts["variable_slot"] == before + 1
    _assert_close(got, G.variable_slot_reference(var_in, sp))


def _assert_variable_slot(h: dict, sp) -> None:
    """The variable slot's kernel against its plain version, and a gated-off
    robot's old belief passed through bit for bit."""
    got = G.variable_slot(h, sp)
    torch.cuda.synchronize()
    _assert_close(got, G.variable_slot_reference(h, sp))
    off = h["gate"][0] <= 0
    for name, x in got.items():
        assert torch.equal(x[..., off], h[name][..., off]), name


@pytest.mark.parametrize("R, gates", [(1024, "on"), (1024, "crossing"), (1021, "crossing"),
                                      (1021, "off")])
def test_variable_slot_kernel_bench_shapes(slot_inputs, R, gates):
    """The bench shape (V=21, R=1024: whole 8-robot tiles, 16-byte copies)
    and a ragged R=1021 (4-byte copies, a partial last tile), from the
    crossing's inputs repeated over the chain and the swarm; every robot
    gated on, the crossing's gates (every fifth robot off) or every robot
    off."""
    slot_in, sp, _, _ = slot_inputs
    h, sp = chain_of(slot_in, sp, 21)
    h = swarm_of({n: h[n] for n in G._VAR_IN_FIELDS}, R)
    if gates != "crossing":
        h["gate"] = torch.full_like(h["gate"], 1.0 if gates == "on" else 0.0)
    _assert_variable_slot(h, sp)


@pytest.mark.parametrize("V, tile", [(3, 8), (70, 8), (71, 4), (139, 4), (140, 2), (300, 1)])
def test_variable_slot_kernel_smaller_tiles(slot_inputs, V, tile):
    """The shortest chain, and chains on both sides of each tile size's
    limit (8 robots a block up to V = 70, then 4, 2 and 1; a block of 512
    threads passes over a chain longer than 512 / (2 x tile)): the
    crossing's chain repeated to V, the crossing's gates (some robots off)."""
    slot_in, sp, _, _ = slot_inputs
    h, sp = chain_of(slot_in, sp, V)
    assert G._lib().gbp_variable_tile(V) == tile
    _assert_variable_slot({n: h[n] for n in G._VAR_IN_FIELDS}, sp)


@pytest.mark.parametrize("fault", ["dtype", "contiguity", "shape", "sdf"])
def test_wrapper_refuses_what_the_kernel_does_not_take(slot_inputs, fault):
    slot_in, sp, sdf, world = slot_inputs
    bad = dict(slot_in)
    x = bad["belief_lam"]
    if fault == "sdf":
        sdf = sdf.double()
    else:
        bad["belief_lam"] = {
            "dtype": x.double(),
            "contiguity": x.transpose(0, 1),
            "shape": x[..., :-1],
        }[fault]
    before = G.launch_counts["internal_slot"]
    with pytest.raises((TypeError, ValueError)):
        G.internal_slot(bad, sdf, world, sp)
    assert G.launch_counts["internal_slot"] == before


@pytest.fixture(scope="module")
def sender_inputs(device):
    """The message table's inputs of the crossing in "sender" mode after 12
    plain ticks, with the seeded flags of every third robot cleared on every
    other variable (tests/test_ir_slot.py) so the empty-cavity guard runs."""
    params, state, sdf = crossing(device, "sender")
    state = T.run_ticks(state, sdf, params, 12)
    inputs = EX.sender_inputs(state, params)
    inputs["seeded"] = inputs["seeded"].clone()
    inputs["seeded"][::3, :, ::2] = False
    return inputs, params.sigma_factor_interrobot


def _assert_table_close(inputs: dict, sigma: float, label: str) -> None:
    """K3 with every factor taken (the whole table) against its plain
    version."""
    taken = _smoke().every_factor_taken(torch, inputs)
    before = IR.launch_counts["interrobot_slot"]
    got = IR.interrobot_slot(**inputs, sigma=sigma, **taken)
    torch.cuda.synchronize()
    assert IR.launch_counts["interrobot_slot"] == before + 1
    want = IR.interrobot_slot_reference(**inputs, sigma=sigma, **taken)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(torch.isfinite(got).all())
    live_got, live_want = (got != 0).any(dim=-1), (want != 0).any(dim=-1)
    assert int(live_want.sum()) > 0                  # factors within the safety distance
    assert torch.equal(live_got, live_want)          # no guard decides differently
    scale = want.abs().amax(dim=-1).clamp(min=1.0)
    err = float(((got - want).abs().amax(dim=-1) / scale)[live_want].max())
    print(f"interrobot_slot {label}: {int(live_want.sum())} live messages, "
          f"error over own scale {err:.3e}")
    assert err <= IR_RTOL
    unseeded = ~inputs["seeded"]
    assert bool((got[unseeded] == 0).all())          # empty cavity, empty message


def test_interrobot_slot_kernel_matches_plain(sender_inputs):
    _assert_table_close(*sender_inputs, "crossing")


def synthetic_table_inputs(device) -> dict:
    """The message table's inputs at the bench shapes (R=1024, K=32, V=21):
    random symmetric positive cavities from seeded numpy, peers within 1.2
    safety distances, a third of the slots unseeded."""
    rng = np.random.default_rng(11)
    R, K, V = 1024, 32, 21
    a = rng.normal(size=(R, V, 4, 4))
    lam = a @ a.transpose(0, 1, 3, 2) * rng.uniform(1.0, 1e4, size=(R, V, 1, 1)) + np.eye(4)
    mu = rng.uniform(-800.0, 800.0, size=(R, V, 4))
    safety = np.full(R, 4.4)
    dist = 1.2 * safety[:, None, None] * rng.random((R, K, V - 1))
    ang = 2 * np.pi * rng.random((R, K, V - 1))
    p_ext = mu[:, None, 1:, :2] + np.stack([dist * np.cos(ang), dist * np.sin(ang)], axis=-1)

    def f32(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32, device=device)

    return dict(
        seeded=torch.as_tensor(rng.random((R, K, V - 1)) > 0.33, device=device),
        p_ext=f32(p_ext), snap_mu=f32(mu), snap_eta=f32(rng.normal(size=(R, V, 4)) * 100),
        snap_lam=f32(lam), safety=f32(safety), gids=f32(np.arange(R)),
    )


def test_interrobot_slot_kernel_bench_shapes(device):
    """A synthetic table at the bench shapes (`synthetic_table_inputs`)."""
    _assert_table_close(synthetic_table_inputs(device), 0.01, "bench shapes")


@pytest.mark.parametrize("fault", ["dtype", "contiguity", "shape", "alignment"])
def test_interrobot_wrapper_refuses_what_the_kernel_does_not_take(sender_inputs, fault):
    inputs, sigma = sender_inputs
    x = inputs["p_ext"]
    bad = {**inputs, "p_ext": {
        "dtype": x.double(),
        "contiguity": x.transpose(0, 1).contiguous().transpose(0, 1),
        "shape": x[:, :, :-1],
        # contiguous, but 4 bytes past an 8-byte boundary
        "alignment": torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(x.shape),
    }[fault]}
    before = IR.launch_counts["interrobot_slot"]
    with pytest.raises((TypeError, ValueError)):
        IR.interrobot_slot(**bad, sigma=sigma, **_smoke().every_factor_taken(torch, inputs))
    assert IR.launch_counts["interrobot_slot"] == before


@pytest.mark.parametrize(
    "dtype, width, offset, word",
    [
        (torch.float32, 80, 0, 16),    # the sender delivery's rows (V1=20)
        (torch.float32, 160, 0, 16),   # receiver_compact's table rows
        (torch.float32, 480, 0, 16),   # the receiver pack's rows
        (torch.float32, 3, 0, 4),      # 12-byte rows
        (torch.float64, 5, 0, 8),      # 40-byte rows
        (torch.float32, 4, 1, 4),      # 16-byte rows from a 4-byte aligned start
        (torch.uint8, 13, 0, 1),
        (torch.bool, 6, 0, 2),
    ],
)
@pytest.mark.parametrize("masked", [False, True])
def test_gather_rows_kernel_is_index_select(device, dtype, width, offset, word, masked):
    g = torch.Generator(device=device).manual_seed(width)
    n, m = 301, 977
    flat = (torch.randn(n * width + offset, generator=g, device=device) * 100).to(dtype)
    table = flat[offset:].view(n, width)
    idx = torch.randint(0, n, (m,), generator=g, device=device)
    mask = torch.rand(m, generator=g, device=device) > 0.4 if masked else None
    before = L.launch_counts["gather_rows"]
    got = L.gather_rows(table, idx, mask)
    torch.cuda.synchronize()
    assert L.launch_counts["gather_rows"] == before + 1
    assert L.word_bytes(table, got) == word
    assert got.dtype == dtype and torch.equal(got, L.gather_rows_reference(table, idx, mask))


@pytest.mark.parametrize("word", [16, 8, 4, 2, 1])
@pytest.mark.parametrize(
    "words",
    [
        3,      # 85 rows a block, a warp's lanes across 11 or 12 rows
        10,     # the response's width: 25 rows a block
        20,     # the delivery's width: 12 rows a block, a warp across 2 or 3 rows
        40,     # the compact table's width: 6 rows a block
        50,     # a row wider than a warp: 5 rows a block
        120,    # the receiver pack's width: 2 rows a block
        257,    # a row of 2 slices of 256 words, the second of one word
        1500,   # a row of 6 slices of 256 words, the last one partial
    ],
)
@pytest.mark.parametrize("masked", [False, True])
def test_gather_rows_kernel_row_widths(device, word, words, masked):
    """Rows of `words` words of `word` bytes, from a byte table whose start
    is aligned to `word` bytes and no more, so the kernel copies with that
    word; 333 output rows, so the last block of rows is partial (333 is a
    multiple of none of the 85, 25, 12, 6, 5 and 2 rows a block takes)."""
    g = torch.Generator(device=device).manual_seed(words + word)
    n, m, row = 67, 333, words * word
    offset = 0 if word == 16 else word
    flat = torch.randint(0, 256, (n * row + offset,), generator=g, device=device,
                         dtype=torch.uint8)
    table = flat[offset:].view(n, row)
    idx = torch.randint(0, n, (m,), generator=g, device=device)
    mask = torch.rand(m, generator=g, device=device) > 0.4 if masked else None
    got = L.gather_rows(table, idx, mask)
    torch.cuda.synchronize()
    assert L.word_bytes(table, got) == word
    assert torch.equal(got, L.gather_rows_reference(table, idx, mask))


# --------------------------------------------------------------------------
# the sender exchange's selects, inside K3 and K4
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sender_slice(device):
    """The bench workload under "sender" after 100 ticks of the kernels'
    path (live factors, as chip_smoke's sender slice ends): (params, state)."""
    from magics_tpu_torch.bench.headline import bench_scenario

    params, state, sdf = bench_scenario("sender", device=device)
    return params, T.run_ticks(state, sdf, params, 100)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return _smoke().bits_equal(torch, a, b)


def _nan_pattern(shape, device, seed: int) -> torch.Tensor:
    """Random float32 entries with a NaN in every third, so that a row the
    kernel leaves unwritten, or takes where it should keep, shows."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = torch.randn(shape, generator=g, device=device) * 100
    out.view(-1)[::3] = float("nan")
    return out


def _select_masks(R: int, K: int, device):
    """A send gate [R] and a live-slot mask [R, K] that leave whole blocks
    of the table taken (gate and every slot on: every 5th robot), whole
    blocks kept (gate off: every 7th) and the rest mixed."""
    g = torch.Generator(device=device).manual_seed(3)
    gate = torch.rand(R, generator=g, device=device) > 0.3
    mask = torch.rand((R, K), generator=g, device=device) > 0.5
    gate[::5], mask[::5] = True, True
    gate[::7] = False
    return gate, mask


@pytest.mark.parametrize("inputs_of", ["sender slice after 100 ticks", "synthetic bench shapes"])
def test_interrobot_slot_select_bit_equal_to_where(device, sender_slice, inputs_of):
    """K3 given the old outbox, the send gates and the live-slot mask writes
    `where(gate & mask, table, old)` bit for bit, in one launch, `table`
    being what it writes with every factor taken."""
    if inputs_of == "synthetic bench shapes":
        inputs, sigma = synthetic_table_inputs(device), 0.01
    else:
        params, state = sender_slice
        inputs, sigma = EX.sender_inputs(state, params), params.sigma_factor_interrobot
    R, K, V1 = inputs["seeded"].shape
    gate, mask = _select_masks(R, K, device)
    old = _nan_pattern((R, K, V1, 4), device, R)
    table = IR.interrobot_slot(**inputs, sigma=sigma, **_smoke().every_factor_taken(torch, inputs))
    before = IR.launch_counts["interrobot_slot"]
    got = IR.interrobot_slot(**inputs, sigma=sigma, old=old, send_gate=gate, nbr_mask=mask)
    torch.cuda.synchronize()
    assert IR.launch_counts["interrobot_slot"] == before + 1
    take = (gate[:, None] & mask)[..., None, None]
    assert _bits_equal(got, torch.where(take, table, old))
    assert bool((table[take.expand_as(table)] != 0).any())      # live messages taken


@pytest.mark.parametrize("fault", ["old without gate", "old shape", "gate dtype", "mask shape"])
def test_interrobot_select_refuses_what_the_kernel_does_not_take(sender_inputs, fault):
    inputs, sigma = sender_inputs
    R, K, V1 = inputs["seeded"].shape
    dev = inputs["seeded"].device
    select = dict(old=torch.zeros((R, K, V1, 4), device=dev),
                  send_gate=torch.ones(R, dtype=torch.bool, device=dev),
                  nbr_mask=torch.ones((R, K), dtype=torch.bool, device=dev))
    if fault == "old without gate":
        del select["send_gate"]
    elif fault == "old shape":
        select["old"] = select["old"][:, :, :-1]
    elif fault == "gate dtype":
        select["send_gate"] = select["send_gate"].float()
    else:
        select["nbr_mask"] = select["nbr_mask"][:, :-1]
    before = IR.launch_counts["interrobot_slot"]
    with pytest.raises((TypeError, ValueError)):
        IR.interrobot_slot(**inputs, sigma=sigma, **select)
    assert IR.launch_counts["interrobot_slot"] == before


@pytest.mark.parametrize("site, word", [("sender delivery", 16), ("sender response", 16),
                                        ("12-byte rows", 4), ("old 4 bytes off", 4)])
def test_gather_rows_with_old_bit_equal_to_where(device, sender_slice, site, word):
    """K4 given old rows writes `where(mask, index_select, old)` bit for bit:
    at the sender's two call sites on the 100-tick state (rows of 320 and
    160 bytes, 16-byte words), at 12-byte rows, and with 16-byte-wide rows
    whose old table starts 4 bytes past a 16-byte boundary (the old table
    sets the word too: 4 bytes)."""
    params, state = sender_slice
    sites = _smoke().gather_sites(torch, state)
    if site in sites:
        tab, idx, mask = sites[site]
    else:
        tab, idx, mask = sites["sender delivery"]
        if site == "12-byte rows":
            tab = tab[:, :3].contiguous()
    n, m = idx.shape[0], tab.shape[1]
    g = torch.Generator(device=device).manual_seed(m)
    mask = mask & (torch.rand(n, generator=g, device=device) > 0.2)   # as `deliver` is
    offset = 1 if site == "old 4 bytes off" else 0
    old = _nan_pattern(n * m + offset, device, m)[offset:].view(n, m)
    before = L.launch_counts["gather_rows"]
    got = L.gather_rows(tab, idx, mask, old)
    torch.cuda.synchronize()
    assert L.launch_counts["gather_rows"] == before + 1
    assert L.word_bytes(tab, got, old) == word
    assert bool(mask.any()) and bool((~mask).any())
    assert _bits_equal(got, torch.where(mask[:, None], tab.index_select(0, idx), old))
    assert _bits_equal(L.gather_rows(tab, idx, mask),
                       torch.where(mask[:, None], tab.index_select(0, idx), 0.0))


def _external_ops_a_slot(graph, n_ext: int) -> float:
    """Device operations a captured tick runs in its `gbp.external` stages,
    over its external slots."""
    stages = graph.stages
    ends = stages.starts[1:] + (stages.ops,)
    return sum(end - start for name, start, end in zip(stages.names, stages.starts, ends)
               if name == "gbp.external") / n_ext


def test_captured_sender_slot_runs_no_selects(device, monkeypatch):
    """One captured tick of the swarm workload (bench/scale.py, R cut to
    2,048): the sender's external slot runs four device operations fewer
    than with the selects outside the kernels (the three `where`s, and the
    gate-and-mask `&` that K3 now forms itself), with the same kernel
    launches, `expected_launches`, and the same bits."""
    from magics_tpu_torch.bench.scale import scale_scenario
    from magics_tpu_torch.graph import gbp as GBP
    from magics_tpu_torch.graph.chunk import compile_ticks

    params, state, sdf = scale_scenario(2048, "sender", device=device)
    state = T.run_ticks(state, sdf, params, 3)
    n_ext = sum(1 for _, e in params.schedule if e)
    folded = compile_ticks(state, sdf, params, 1)
    folded.replay()

    def factor_pass(self, state, params, comm=EX.LOCAL, kernels=False):
        """The exchange with the selects as plain operations: each `where`
        after a kernel, as they ran before the kernels took them (K3's own
        select leaves that `where` nothing to change, and makes no
        operation of its own)."""
        send_gate = EX.sender_gate(state)
        msg = IR.interrobot_slot(**EX.sender_inputs(state, params, comm),
                                 sigma=params.sigma_factor_interrobot, old=state.ir_f2v_ext,
                                 send_gate=send_gate, nbr_mask=state.nbr_mask)
        produced = send_gate[:, None] & state.nbr_mask
        ir_f2v_ext = torch.where(produced[..., None, None], msg, state.ir_f2v_ext)
        _, deliver = EX._delivered(state, send_gate, comm)
        in_msg = EX.gather_from_peer(comm.all_robots(ir_f2v_ext), state.nbr_idx,
                                     state.nbr_back, state.nbr_mask)
        return replace(state, ir_f2v_ext=ir_f2v_ext,
                       ext_inbox=torch.where(deliver[..., None, None], in_msg, state.ext_inbox),
                       iter_count_factor=state.iter_count_factor + send_gate.to(torch.int32))

    def deliver_responses(self, state, gate, own_pos, comm=EX.LOCAL):
        src, deliver = EX._delivered(state, gate, comm)
        in_pos = EX.gather_rows_pinned(comm.all_robots(own_pos), src, state.nbr_mask)
        return EX._responses(state, deliver, in_pos)

    monkeypatch.setattr(EX.Sender, "factor_pass", factor_pass)
    monkeypatch.setattr(EX.Sender, "deliver_responses", deliver_responses)
    apart = compile_ticks(state, sdf, params, 1)
    apart.replay()
    torch.cuda.synchronize()
    expected = GBP.expected_launches(params, device)
    assert folded.launches == apart.launches == expected
    assert expected["interrobot_slot"] == n_ext and expected["gather_rows"] == 2 * n_ext
    ops = _external_ops_a_slot(folded, n_ext), _external_ops_a_slot(apart, n_ext)
    print(f"gbp.external device operations a slot: {ops[0]} folded, {ops[1]} apart")
    assert ops[0] == ops[1] - 4
    assert folded.stages.ops == apart.stages.ops - 4 * n_ext
    _assert_states_bit_equal(folded.state, apart.state)


# --------------------------------------------------------------------------
# the external sums (kernels/ext_sum.py)
# --------------------------------------------------------------------------

def _assert_sums_close(x: torch.Tensor) -> tuple:
    """The kernel's sums of `x` against the plain version's, each entry
    within `ext_sum.sum_tolerance` (0 where every term is 0, so the zero
    planes are held exactly); one launch. Returns the kernel's planes."""
    before = E.launch_counts["ext_sum"]
    got = E.ext_sum_hot(x)
    torch.cuda.synchronize()
    assert E.launch_counts["ext_sum"] == before + 1
    for g, w, tol in zip(got, E.ext_sum_hot_reference(x), E.sum_tolerance(x)):
        assert g.dtype == torch.float32 and g.shape == w.shape and g.is_contiguous()
        err = (g.double() - w.double()).abs()
        assert bool((err <= tol).all()), float((err - tol).max())
    return got


@pytest.mark.parametrize("R, K, V1", [
    (50, 49, 20),       # the Circle Experiment: 4 blocks, the last ragged
    (16384, 24, 20),    # the swarm: 1,024 blocks
    (37, 7, 20),        # 37 robots: the last tile ragged
    (16381, 24, 20),    # the last tile ragged
    (300, 5, 69),       # three position tiles (32, 32, 5)
    (9, 1, 2),
    (40, 70, 20),       # K >= 64: PyTorch splits the sum, another order
])
def test_ext_sum_kernel_matches_plain(device, R, K, V1):
    eta, lam = _assert_sums_close(_smoke().seeded_inbox(torch, R, K, V1, seed=R + K))
    assert bool(eta[:2, 1:].any()) and bool(lam[:2, :2, 1:].any())


@pytest.mark.parametrize("R, K, V1", [(50, 49, 20), (30, 29, 20), (16384, 24, 20), (9, 1, 2)])
def test_ext_sum_kernel_bit_equal_to_the_plain_cuda_sums(device, R, K, V1):
    """Below 64 terms a sum, PyTorch's CUDA reduction sums over k in four
    interleaved partial sums, one thread an output, and the kernel takes
    the same order: its planes are the plain version's bits, so a run
    through the kernel follows the plain sums' trajectory. Checked on
    PyTorch 2.11.0+cu128: a failure after a PyTorch upgrade may be a new
    reduction order in PyTorch, not a fault of the kernel."""
    x = _smoke().seeded_inbox(torch, R, K, V1, seed=R * K)
    for g, w in zip(E.ext_sum_hot(x), E.ext_sum_hot_reference(x)):
        assert torch.equal(g, w)


def test_ext_sum_kernel_all_zero_inbox_writes_every_entry(device):
    """A zero inbox gives zero planes, also where the planes' memory held
    NaNs just before (the caching allocator hands the same blocks back)."""
    R, K, V1 = 1021, 24, 20
    junk = [torch.full((4, V1 + 1, R), float("nan"), device=device),
            torch.full((4, 4, V1 + 1, R), float("nan"), device=device)]
    del junk
    for g in _assert_sums_close(torch.zeros((R, K, V1, 4), device=device)):
        assert torch.equal(g, torch.zeros_like(g))


def test_ext_sum_kernel_bits_independent_of_R_and_tile(device):
    """A robot's sums are the same bits in a launch of 16,384 robots and of
    a slice of 1,000 of them, whose last tile is ragged and whose robots
    sit at other places in their tiles: each sum runs over k in one
    thread, so a shard of the swarm sums as the whole."""
    x = _smoke().seeded_inbox(torch, 16384, 24, 20, seed=3)
    whole = E.ext_sum_hot(x)
    for lo in (0, 5003):
        part = E.ext_sum_hot(x[lo:lo + 1000].contiguous())
        for a, b in zip(whole, part):
            assert torch.equal(a[..., lo:lo + 1000], b)


@pytest.mark.parametrize("fault", ["dtype", "contiguity", "shape", "alignment"])
def test_ext_sum_wrapper_refuses_what_the_kernel_does_not_take(device, fault):
    x = _smoke().seeded_inbox(torch, 37, 7, 20)
    bad = {
        "dtype": x.double(),
        "contiguity": x.transpose(0, 1).contiguous().transpose(0, 1),
        "shape": x[..., :3].contiguous(),
        # contiguous, but 4 bytes past a 16-byte boundary
        "alignment": torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(x.shape),
    }[fault]
    before = E.launch_counts["ext_sum"]
    with pytest.raises((TypeError, ValueError)):
        E.ext_sum_hot(bad)
    assert E.launch_counts["ext_sum"] == before


# --------------------------------------------------------------------------
# the compact exchange (K5: kernels/compact_exchange.py)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("gates", ["on", "off", "mixed"])
@pytest.mark.parametrize("shape", ["bench", "ragged", "circle", "swarm"])
def test_compact_exchange_kernels_bit_equal_to_plain(device, shape, gates):
    """Both K5 kernels against their plain versions at chip_smoke's
    COMPACT_SHAPES (R=1024, K=32; R=1021; the Circle's K=49; R=16384,
    K=24; V=21), on seeded inputs with singular, rank-deficient, inf and
    NaN cavities, unseeded mirrors, empty and non-reciprocal slots, the
    gates all on, all off or mixed: the tables, gates, counter and inbox
    bit for bit, the inbox allocated over NaN-filled memory
    (chip_smoke.compact_compare)."""
    R, K, V = _smoke().COMPACT_SHAPES[shape]
    before = dict(CX.launch_counts)
    counts = _smoke().compact_compare(
        torch, *_smoke().compact_inputs(torch, R, K, V, seed=R + K, gates=gates), shape)
    assert CX.launch_counts == {k: v + 1 for k, v in before.items()}
    if gates != "off":
        assert counts["delivered_slots"] and counts["live_messages"]
        assert 0.0 < counts["valid_tables"] < 1.0


def test_compact_exchange_kernels_on_a_crossing(device):
    """K5 bit-equal to its plain version on the inputs a tick hands it: the
    37-robot crossing under receiver_compact after 12 plain ticks, with
    live factors."""
    params, state, sdf = crossing(device)
    state = T.run_ticks(state, sdf, params, 12)
    counts = _smoke().compact_compare(torch, *_smoke().compact_state_inputs(state, params),
                                      "crossing")
    assert counts["live_messages"] > 0


def test_compact_exchange_pass_bit_equal_to_its_plain_versions(device):
    """The kernels' path of the crossing under receiver_compact (use_pallas
    on) for 12 ticks, against the same path with K5's plain versions in
    its place: every field bit for bit, with two launches an external
    slot and no row gather."""
    params, state, sdf = crossing(device, use_pallas=True)
    n_ext = sum(1 for _, e in params.schedule if e)
    before = {**CX.launch_counts, **L.launch_counts}
    kern = T.run_ticks(state, sdf, params, 12)
    torch.cuda.synchronize()
    after = {**CX.launch_counts, **L.launch_counts}
    assert {k: after[k] - before[k] for k in after} == {
        "compact_table": 12 * n_ext, "compact_message": 12 * n_ext, "gather_rows": 0}
    real = CX.compact_tables, CX.compact_messages
    CX.compact_tables, CX.compact_messages = (CX.compact_tables_reference,
                                              CX.compact_messages_reference)
    try:
        plain = T.run_ticks(state, sdf, params, 12)
    finally:
        CX.compact_tables, CX.compact_messages = real
    _assert_states_bit_equal(kern, plain)
    assert float(kern.ext_inbox.abs().sum()) > 0.0


@pytest.mark.parametrize("fault", ["dtype", "device", "contiguity", "shape", "alignment"])
def test_compact_exchange_wrappers_refuse_what_the_kernels_do_not_take(device, fault):
    tables, messages = _smoke().compact_inputs(torch, 37, 7, 21)
    tab, gate, _ = CX.compact_tables_reference(*tables)
    kw = dict(tables_all=tab, gate=gate, gate_all=gate, **messages)

    def spoil(x):
        return {
            "dtype": x.double(),
            "device": x.cpu(),
            "contiguity": x.transpose(0, 1).contiguous().transpose(0, 1),
            "shape": x[:, :-1].contiguous(),
            # contiguous, but 4 bytes past a 16-byte boundary
            "alignment": torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(x.shape),
        }[fault]

    before = dict(CX.launch_counts)
    with pytest.raises((TypeError, ValueError)):
        CX.compact_tables(tables[0], spoil(tables[1]), *tables[2:])
    with pytest.raises((TypeError, ValueError)):
        CX.compact_messages(**{**kw, "p_ext": spoil(kw["p_ext"])})
    assert CX.launch_counts == before


def test_default_scenario_runs_the_kernels(device):
    """A scenario built without `use_pallas` on the card runs every slot
    through the kernels: per tick one internal_slot per internal slot, one
    variable_slot, one interrobot_slot and two gather_rows per external,
    and one ext_sum before the schedule and one per external slot."""
    params, state, sdf = build_scenario(
        circle_formation(37, circle_radius=30.0, target_speed=15.0), target_speed=15.0,
        planning_horizon=3.0, comms_radius=20.0, internal=4, external=2, n_slots=8,
        world=(200.0, 200.0), sdf=np.ones((64, 64)),
    )
    assert state.device.type == "cuda" and params.use_pallas is None
    n_int = sum(1 for i, _ in params.schedule if i)
    n_ext = sum(1 for _, e in params.schedule if e)
    before = {**G.launch_counts, **IR.launch_counts, **L.launch_counts, **E.launch_counts}
    T.run_ticks(state, sdf, params, 2)
    torch.cuda.synchronize()
    after = {**G.launch_counts, **IR.launch_counts, **L.launch_counts, **E.launch_counts}
    assert {n: after[n] - before[n] for n in after} == {
        "internal_slot": 2 * n_int, "variable_slot": 2 * n_ext,
        "interrobot_slot": 2 * n_ext, "gather_rows": 4 * n_ext, "ext_sum": 2 * (1 + n_ext)}


def test_sender_kernel_path_tracks_plain_path(device):
    """12 ticks of the crossing in "sender" mode through the kernels against
    the port's plain passes (which still gather through K4 on the card):
    positions within chip_smoke.py's 0.1 m, and each external slot launches
    one message table and two row gathers."""
    from dataclasses import replace

    params, state, sdf = crossing(device, "sender")
    n_ext = sum(1 for _, e in params.schedule if e)
    plain = T.run_ticks(state, sdf, params, 12)
    before = (IR.launch_counts["interrobot_slot"], L.launch_counts["gather_rows"])
    kern = T.run_ticks(state, sdf, replace(params, use_pallas=True), 12)
    torch.cuda.synchronize()
    assert IR.launch_counts["interrobot_slot"] - before[0] == 12 * n_ext
    assert L.launch_counts["gather_rows"] - before[1] == 2 * 12 * n_ext
    assert float((kern.pos - state.pos).abs().max()) > 1.0
    assert float(kern.ext_inbox.abs().sum()) > 0.0
    assert float((plain.pos - kern.pos).abs().max()) < 0.1


# --------------------------------------------------------------------------
# chunks captured as CUDA graphs (graph/chunk.py) against the eager ticks
# --------------------------------------------------------------------------

GRID = dict(grid_cell_size=10.0, grid_capacity=16, collision_partners=8)


def _smoke():
    """chip_smoke.py, whose input builders and bit comparison these tests
    share with the card's smoke run."""
    import importlib.util
    import pathlib
    import sys

    if "chip_smoke" not in sys.modules:
        path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules["chip_smoke"] = module
    return sys.modules["chip_smoke"]


def _assert_states_bit_equal(a, b) -> None:
    bad = _smoke().differing_fields(torch, a, b)
    assert not bad, f"fields differ: {bad}"


@pytest.mark.parametrize("path", ["dense", "grid"])
@pytest.mark.parametrize("exchange", ["sender", "receiver", "receiver_compact"])
def test_graph_replay_bit_equal_to_eager(device, exchange, path):
    """Two replays of a captured 4-tick chunk against 8 eager ticks from the
    same state, the kernels on: every field bit-equal (no op of the tick
    uses atomics). The capture counts each kernel's launches for one chunk;
    replays add none."""
    from magics_tpu_torch.graph.chunk import compile_ticks

    params, state, sdf = crossing(device, exchange, use_pallas=None, log_every=2,
                                  log_capacity=3, collision_log_capacity=8,
                                  **(GRID if path == "grid" else {}))
    state = T.run_ticks(state, sdf, params, 3)
    eager = T.run_ticks(state, sdf, params, 8)
    graph = compile_ticks(state, sdf, params, 4)
    n_int = sum(1 for i, _ in params.schedule if i)
    n_ext = sum(1 for _, e in params.schedule if e)
    compact = exchange == "receiver_compact"
    assert graph.launches == {
        "internal_slot": 4 * n_int, "variable_slot": 4 * n_ext,
        "interrobot_slot": 4 * n_ext if exchange == "sender" else 0,
        "gather_rows": 4 * n_ext * {"sender": 2, "receiver": 1, "receiver_compact": 0}[exchange],
        "ext_sum": 4 * (1 + n_ext), "compact_table": 4 * n_ext if compact else 0,
        "compact_message": 4 * n_ext if compact else 0}
    before = {**G.launch_counts, **IR.launch_counts, **L.launch_counts, **E.launch_counts}
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert {**G.launch_counts, **IR.launch_counts, **L.launch_counts, **E.launch_counts} == before
    _assert_states_bit_equal(graph.state, eager)
    assert float((eager.pos - state.pos).abs().max()) > 1.0
    # re-seeded by a device copy, it runs the same chunk again
    graph.load(state)
    graph.replay()
    _assert_states_bit_equal(graph.state, T.run_ticks(state, sdf, params, 4))


def test_graph_replay_outlives_other_cached_constants(device):
    """A captured chunk reads the cached timesteps tensor on every replay:
    after 40 other (timesteps, dtype, device) keys have been cached and the
    allocator's blocks churned, a replay is still bit-equal to eager."""
    from magics_tpu_torch.graph.chunk import compile_ticks

    params, state, sdf = crossing(device, "receiver_compact", use_pallas=None)
    graph = compile_ticks(state, sdf, params, 2)
    for k in range(40):
        other = replace(params, variable_timesteps=tuple(range(k + 2)))
        device_timesteps(other, torch.float32, state.device)
        del other
        churn = torch.full((4096,), float(k), device=device)
        del churn
    graph.replay()
    _assert_states_bit_equal(graph.state, T.run_ticks(state, sdf, params, 2))


def test_graph_comms_failure_draws_match_eager(device):
    """comms_failure_rate 0.3 from a registered generator: each replay draws
    anew, and the antenna masks of 6 one-tick replays equal those of 6 eager
    ticks from a generator in the same state."""
    from magics_tpu_torch.graph.chunk import compile_ticks

    params, state, sdf = crossing(device, "sender", use_pallas=None, comms_failure_rate=0.3)
    gen_eager = torch.Generator(device=device).manual_seed(5)
    gen_graph = torch.Generator(device=device).manual_seed(5)
    eager, masks_eager = state, []
    for _ in range(6):
        eager = T.step(eager, sdf, params, generator=gen_eager)
        masks_eager.append(eager.antenna.clone())
    graph = compile_ticks(state, sdf, params, 1, generator=gen_graph)
    masks_graph = []
    for _ in range(6):
        graph.replay()
        masks_graph.append(graph.state.antenna.clone())
    eager_m, graph_m = torch.stack(masks_eager), torch.stack(masks_graph)
    n = eager_m.numel()
    share = float((~graph_m).float().mean())
    print(f"comms failure: graph share {share:.3f}, eager {float((~eager_m).float().mean()):.3f}"
          f" of {n} draws; masks equal: {torch.equal(eager_m, graph_m)}")
    assert not all(torch.equal(masks_graph[0], m) for m in masks_graph[1:])   # drawn anew
    assert torch.equal(eager_m, graph_m)
    _assert_states_bit_equal(graph.state, eager)


def test_compile_ticks_refuses_a_state_off_the_card(device):
    from magics_tpu_torch.graph.chunk import compile_ticks

    params, state, sdf = crossing("cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        compile_ticks(state, sdf, params, 2)


# --------------------------------------------------------------------------
# the four kernels at the scale shapes (R=16384, K=24, V=21)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scale_states(device):
    """The scale workload of magics_tpu_torch/bench/scale.py at R=16384,
    after 3 eager ticks of the grid path, under "sender" and
    "receiver_compact": {exchange: (params, state, sdf)}."""
    from magics_tpu_torch.bench.scale import scale_scenario

    out = {}
    for exchange in ("sender", "receiver_compact"):
        params, state, sdf = scale_scenario(16384, exchange, device=device)
        out[exchange] = params, T.run_ticks(state, sdf, params, 3), sdf
    return out


def test_slot_kernels_at_scale_shapes(scale_states):
    params, state, sdf = scale_states["receiver_compact"]
    assert state.n_robots == 16384 and params.n_slots == 24 and params.n_vars == 21
    h = _smoke().slot_inputs(state, params)
    sp = HOT.slot_params(params)
    world = (params.world_width, params.world_height)
    _assert_close(G.internal_slot(h, sdf, world, sp),
                  G.internal_slot_fused_reference(h, sdf, world, sp))
    var_in = {n: h[n] for n in G._VAR_IN_FIELDS}
    _assert_variable_slot(var_in, sp)


def test_interrobot_kernel_at_scale_shapes(scale_states):
    """The sender state's table inputs with each external position moved to
    a seeded point within 1.2 safety distances of its snapshot (the ring's
    4.9 m spacing leaves no factor inside the 4.4 m safety distance yet),
    every third robot's cavities unseeded on every other variable."""
    params, state, _ = scale_states["sender"]
    inputs = EX.sender_inputs(state, params)
    R, K, V1 = inputs["seeded"].shape
    assert (R, K, V1) == (16384, 24, 20)
    inputs["seeded"] = inputs["seeded"].clone()
    inputs["seeded"][::3, :, ::2] = False
    g = torch.Generator(device=state.device).manual_seed(0)
    dist = 1.2 * inputs["safety"][:, None, None] * torch.rand(
        (R, K, V1), generator=g, device=state.device)
    angle = 2 * np.pi * torch.rand((R, K, V1), generator=g, device=state.device)
    offset = torch.stack([dist * torch.cos(angle), dist * torch.sin(angle)], dim=-1)
    inputs["p_ext"] = (state.snap_mu[:, None, 1:, :2] + offset).contiguous()
    _assert_table_close(inputs, params.sigma_factor_interrobot, "scale shapes")


@pytest.mark.parametrize("site", ["sender delivery", "sender response", "receiver pack",
                                  "receiver_compact table"])
def test_gather_rows_kernel_at_scale_shapes(scale_states, site):
    """The row gather's call sites at R=16384, K=24 (chip_smoke.gather_sites):
    393,216 rows of the peers' outboxes [R K, 80 floats] or positions
    [R, 40], masked, and of the receivers' tables [R, 480] and the compact
    tables [R, 160], unmasked; seeded tables, the state's indexes."""
    params, state, _ = scale_states["sender"]
    R, K = state.nbr_idx.shape
    assert bool(state.nbr_mask.any())
    tab, idx, m = _smoke().gather_sites(torch, state)[site]
    got = L.gather_rows(tab, idx, m)
    torch.cuda.synchronize()
    assert got.shape == (R * K, tab.shape[1])
    assert torch.equal(got, L.gather_rows_reference(tab, idx, m))


# --------------------------------------------------------------------------
# the kernel-path choice (ROADMAP F10), the JAX reference trajectory, and
# the Simulator on the card
# --------------------------------------------------------------------------

def _crossing_script():
    """scripts/torch_crossing_reference.py (it imports JAX only to write
    the reference, which the card's tests only read)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "torch_crossing_reference.py"
    spec = importlib.util.spec_from_file_location("torch_crossing_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_slot_tiles_reckoned_in_python_are_the_kernels(device):
    """gbp_slot.slot_tile, which decides on the CPU whether the kernels take
    a chain, gives the tile the library picks at every V."""
    lib = G._lib()
    for V in range(1, 900):
        assert G.slot_tile("internal", V) == (lib.gbp_internal_tile(V) if V >= 3 else 0), V
        assert G.slot_tile("variable", V) == (lib.gbp_variable_tile(V) if V >= 3 else 0), V


def test_float64_crossing_runs_on_the_card_and_tracks_the_cpu(device):
    """A float64 crossing built with the default `use_pallas` runs on the
    card (the plain passes, as JAX runs XLA; the row gathers still launch
    K4) and stays within 1e-6 m of the CPU port's float64 run over 10
    ticks."""
    from magics_tpu_torch.sim import builder

    script = _crossing_script()
    params, state, sdf = script.crossing(builder, torch.float64, device=device)
    assert params.use_pallas is None and not params.uses_kernels(state.device)
    cpu_params, cpu_state, cpu_sdf = script.crossing(builder, torch.float64, device="cpu")
    G.reset_launch_counts()
    E.reset_launch_counts()
    card = T.run_ticks(state, sdf, params, 10)
    cpu = T.run_ticks(cpu_state, cpu_sdf, cpu_params, 10)
    assert G.launch_counts == {"internal_slot": 0, "variable_slot": 0}
    assert E.launch_counts == {"ext_sum": 0}
    assert card.pos.dtype == torch.float64
    drift = float((card.pos.cpu() - cpu.pos).abs().max())
    assert drift <= 1e-6, drift
    assert float((card.pos - state.pos).abs().max()) > 1.0


def test_kernel_crossing_tracks_the_committed_jax_run(device):
    """The 4-robot crossing of tests/test_pallas_slot.py, float32, 20 ticks
    with the kernels on (the default on the card): within 2.0 m of the JAX
    package's run that scripts/torch_crossing_reference.py wrote to
    tests/data/torch_crossing_jax.npz, at every tick."""
    from magics_tpu_torch.sim import builder

    script = _crossing_script()
    want = np.load(script.DEFAULT_OUT)["pos"]
    params, state, sdf = script.crossing(builder, torch.float32, device=device)
    assert params.uses_kernels(state.device)
    G.reset_launch_counts()
    pos = [state.pos.cpu().numpy()]
    for _ in range(script.TICKS):
        state = T.step(state, sdf, params)
        pos.append(state.pos.cpu().numpy())
    assert G.launch_counts["internal_slot"] > 0 and G.launch_counts["variable_slot"] > 0
    err = np.abs(np.stack(pos) - want).max()
    print(f"kernel crossing vs JAX: max |dpos| {err:.3e} m over {script.TICKS} ticks")
    assert err < 2.0, err
    assert np.abs(pos[-1] - pos[0]).max() > 5.0


def test_kernel_lanes_track_the_committed_oracle(device):
    """The parity harness's lanes case (magics_tpu_torch/scripts/
    parity_rmse.py: 6 robots, K=5, V=13, 10 + 10 slots), float32, 80 ticks
    through the kernels (the default on the card): max-over-robots RMSE
    within 3e-3 m of the numpy oracle's committed trajectory (ROADMAP F13),
    completion equal, every kernel of the sender exchange launched on every
    tick (K5, the compact exchange's, on none)."""
    import pathlib

    from magics_tpu_torch.kernels import launch_counts, reset_launch_counts
    from magics_tpu_torch.scripts import parity_rmse as P

    ticks = P.case_ticks("lanes")
    reference = P.load_reference(pathlib.Path(__file__).resolve().parent / "data"
                                 / "torch_oracle_parity.npz")
    reset_launch_counts()
    out = P.run_case("lanes", ticks, reference=reference, dtype=torch.float32, device=device)
    per_tick = {k: v / ticks for k, v in launch_counts().items()}
    print(f"kernel lanes vs the oracle: RMSE {out['rmse_max_m']:.3e} m; launches a tick "
          f"{per_tick}")
    assert per_tick == {"internal_slot": 10.0, "variable_slot": 10.0, "interrobot_slot": 10.0,
                        "gather_rows": 20.0, "ext_sum": 11.0, "compact_table": 0.0,
                        "compact_message": 0.0}
    assert out["rmse_max_m"] < 3e-3
    assert out["completed_dense"] == out["completed_oracle"]


def _small_circle(failure_rate=0.0, robots=8):
    from magics_tpu_torch.config.formation import Formation, FormationGroup
    from magics_tpu_torch.config.loader import Scenario
    from magics_tpu_torch.config.schema import Config
    from magics_tpu_torch.env import builtin

    circle = {"circle": {"radius": 20.0, "center": {"x": 0.5, "y": 0.5}}}
    toml = ("[simulation]\nhz = 10.0\nprng-seed = 3\nmax-time = 20.0\n"
            "[gbp.iteration-schedule]\ninternal = 6\nexternal = 3\n"
            "[robot]\ntarget-speed = 10.0\nplanning-horizon = 2.0\n"
            f"[robot.communication]\nradius = 30.0\nfailure-rate = {failure_rate}\n")
    formation = Formation.parse({
        "robots": robots,
        "initial-position": {"shape": circle, "placement-strategy": "equal"},
        "waypoints": [{"shape": circle, "projection-strategy": "cross"}],
    })
    return Scenario(name="small circle", config=Config.from_toml(toml),
                    environment=builtin.circle(), formations=FormationGroup([formation]))


@pytest.mark.parametrize("failure_rate", [0.0, 0.5])
def test_simulator_graph_run_bit_equal_to_eager_ticks(device, failure_rate):
    """Simulator.run on the card replays 10-tick graphs (a partial last
    chunk eagerly, never a third graph): after 25 ticks every field equals
    25 eager ticks of the same initial state and generator."""
    from magics_tpu_torch.graph.chunk import clone_state
    from magics_tpu_torch.sim.simulator import Simulator

    sim = Simulator(_small_circle(failure_rate))
    start = clone_state(sim.state)
    gen = torch.Generator(device=device).manual_seed(sim.seed)
    sim.run(max_ticks=25, chunk_ticks=10)
    assert sorted(sim.graphs) == [10] and sim.stats.graph_chunks == 2
    assert sim.stats.eager_chunks == 1 and sim.stats.max_graphs_alive == 1
    eager = T.run_ticks(start, sim.sdf, sim.params, 25, sim.env_dist, generator=gen)
    _assert_states_bit_equal(sim.state, eager)
    # the state run() hands back is the caller's: a later replay leaves it be
    kept = clone_state(sim.state)
    held = sim.state
    sim.run(max_ticks=45, chunk_ticks=10)
    _assert_states_bit_equal(held, kept)
    assert sim.stats.loads >= 1 and all(ms >= 0.0 for ms in sim.stats.load_ms())


def test_simulator_live_edit_recaptures(device):
    """A live edit of the params drops the graph that captured the old ones:
    the run after it equals eager ticks under the new params."""
    from magics_tpu_torch.graph.chunk import clone_state
    from magics_tpu_torch.sim.simulator import Simulator, apply_live_set

    sim = Simulator(_small_circle())
    sim.run(max_ticks=10, chunk_ticks=10)
    first = sim.graphs[10]
    apply_live_set(sim, "comms_radius", "5.0")
    start = clone_state(sim.state)
    sim.run(max_ticks=20, chunk_ticks=10)
    assert sim.graphs[10] is not first and len(sim.stats.captures) == 2
    eager = T.run_ticks(start, sim.sdf, sim.params, 10, sim.env_dist, generator=sim.generator)
    _assert_states_bit_equal(sim.state, eager)


def test_stepping_captures_no_graph_per_step_size(device, monkeypatch):
    """The REPL's `step n` and the live view's browser steps run whole chunks
    as replays of the session's graph and the rest eagerly: a REPL session
    of step 1, 3, 5 and 150 and `run` captures one graph (100 ticks), and
    its state equals the same ticks run eagerly; `drive` on its own thread
    at 5-tick chunks, with steps of 3 and 7, captures only its 5-tick one."""
    import io
    import json
    import sys
    import threading
    import time

    from magics_tpu_torch import cli
    from magics_tpu_torch.graph.chunk import clone_state
    from magics_tpu_torch.sim.simulator import Simulator
    from magics_tpu_torch.viz.live import LiveServer

    sim = Simulator(_small_circle())
    start = clone_state(sim.state)
    gen = torch.Generator(device=device).manual_seed(sim.seed)
    monkeypatch.setattr(sys, "stdin", io.StringIO("step 1\nstep 3\nstep 5\nstep 150\nrun\nquit\n"))
    status, sim = cli.interactive_loop(sim, quiet=True)
    assert status["ticks"] > 159 and sim.graphs.keys() == {100}
    assert [n for n, _ in sim.stats.captures] == [100] and sim.stats.max_graphs_alive == 1
    eager = T.run_ticks(start, sim.sdf, sim.params, status["ticks"], sim.env_dist, generator=gen)
    _assert_states_bit_equal(sim.state, eager)

    sim = Simulator(_small_circle())
    live = LiveServer(sim, port=0)
    live.push(sim.state)
    live.submit({"op": "pause"})
    live.submit({"op": "step", "n": 3})
    thread = threading.Thread(target=live.drive, kwargs={"chunk_ticks": 5})
    thread.start()

    def frame_tick() -> int:
        return round(json.loads(live.frames_since(0)[1][-1])["t"] * sim.hz)

    def wait(tick):
        # reads the frames drive pushed: a read of the card from this thread
        # while drive's thread captures a graph would break the capture
        deadline = time.monotonic() + 120
        while frame_tick() != tick and time.monotonic() < deadline:
            time.sleep(0.05)
        assert frame_tick() == tick

    wait(3)
    live.submit({"op": "step", "n": 7})
    wait(10)
    live.submit({"op": "resume"})
    thread.join(timeout=300)
    assert not thread.is_alive() and int(sim.state.tick) > 10
    assert [n for n, _ in sim.stats.captures] == [5] and sim.stats.graph_chunks > 2


@pytest.mark.parametrize("exchange", ["sender", "receiver_compact"])
def test_two_gloo_ranks_on_the_card_bit_equal_to_one_process(device, exchange, tmp_path):
    """Two gloo ranks sharing the card, each with 512 of the scale
    workload's 1024 robots, 3 eager ticks: the gathered state equals 3
    one-process ticks bit for bit in every field (every robot's arithmetic
    is the same; the collectives move bytes and sum integers), and each
    rank launches K1-K5 and the external sums as the schedule says."""
    import dataclasses

    import torch_shard_cases as C
    from magics_tpu_torch.bench.scale import scale_scenario
    from magics_tpu_torch.graph.gbp import expected_launches
    from magics_tpu_torch.parallel.launch import spawn_ranks

    out = tmp_path / "rank0.pt"
    spawn_ranks(C.run_card_case, 2, (exchange, str(out)), backend="gloo", timeout=300)
    got = torch.load(out)
    params, state, sdf = scale_scenario(C.CARD_R, exchange, device)
    want = T.run_ticks(state, sdf, params, C.CARD_TICKS)
    bad = [f.name for f in dataclasses.fields(want)
           if not _smoke().bits_equal(torch, got[f.name].to(device), getattr(want, f.name))]
    assert not bad, bad
    assert bool(want.nbr_mask.any())
    expected = expected_launches(params, device)
    assert expected["internal_slot"] == 10 and expected["ext_sum"] == 11
    if exchange == "sender":
        assert expected["gather_rows"] == 20 and expected["compact_table"] == 0
    else:   # K5 in place of the row gather
        assert expected["gather_rows"] == 0 and expected["compact_message"] == 10
    for rank in range(2):
        launches = torch.load(f"{out}.launches{rank}")
        assert {k: launches[k] for k in expected} == expected, rank

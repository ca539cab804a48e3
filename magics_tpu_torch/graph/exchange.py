"""The inter-robot exchange: every step of the tick whose work depends on
`GbpParams.ext_exchange`, behind one object per exchange, which
`exchange_of(params)` picks (the `ext_exchange` branches of magics_tpu's
graph/tick.py and planner/mission.py).

Two semantics sit behind the three names:

- "sender" (the reference's routing, robot.rs:1803-1831): a robot's rows
  hold its own factors' state. Each factor owner computes its outbox
  `ir_f2v_ext`; each receiver gathers its inbox from the peers' outboxes
  by (peer, reciprocal slot).
- "receiver" and "receiver_compact" (magics_tpu graph/state.py's mirror
  semantics): a robot's rows hold MIRRORS of what the peer's factor holds
  (the peer's cavity flags, MY position as the peer holds it). Each
  receiver recomputes its incoming messages from a row gather of the peers'
  tables: the [V-1, 24] snapshot pack under "receiver" (the sender's rank-1
  maths, so the same inboxes), the [V-1, 8] compact cavity tables under
  "receiver_compact" (Sherman-Morrison, equal to roundoff).

Each object owns, for its exchange: the external positions of new factors
at connectivity (`new_factor_positions`), the horizon's mirrors
(`horizon_mirrors`), the cavities an internal variable pass seeds
(`seed_cavities`), the external factor pass (`factor_pass`), the response
delivery (`deliver_responses`), the reset of an arrived robot's rows
(`reset_arrived`), the per-robot table a sharded run all-gathers
(`table_shape`) and its kernel launches an external slot (`launches`).
Whether the kernels' path runs is the caller's argument: graph/gbp.py
reads `params.uses_kernels` once a tick.

Every row gather of the exchanges goes through `gather_rows_pinned`, one
row gather (K4, kernels/layout.py) where the JAX package pins XLA's layout
around the same gather.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from magics_tpu_torch import profiling
from magics_tpu_torch.graph import factors as F
from magics_tpu_torch.graph.masks import clip_idx, expand_mask, not_idle
from magics_tpu_torch.graph.state import GbpParams, SimState
from magics_tpu_torch.kernels import compact_exchange as CX
from magics_tpu_torch.kernels import ir_slot as IR
from magics_tpu_torch.kernels.layout import gather_rows
from magics_tpu_torch.parallel.comm import LOCAL


# --------------------------------------------------------------------------
# gathers
# --------------------------------------------------------------------------

def gather_rows_pinned(arr: torch.Tensor, idx: torch.Tensor, mask=None,
                       old=None) -> torch.Tensor:
    """out[r, k, ...] = arr[idx[r, k], ...] where `mask` [r, k] holds, else
    `old[r, k, ...]` (0 without `old`): one row gather (K4,
    kernels/layout.py) of `arr` flattened to rows, at each site where the
    JAX package pins XLA's layout around the gather. `idx` is clipped by the
    caller. The result is contiguous."""
    out = gather_rows(
        arr.reshape(arr.shape[0], -1).contiguous(), idx.reshape(-1).long(),
        None if mask is None else mask.reshape(-1),
        None if old is None else old.reshape(idx.numel(), -1).contiguous(),
    )
    return out.reshape(idx.shape + arr.shape[1:])


def gather_from_peer(arr: torch.Tensor, nbr_idx, back, mask, old=None) -> torch.Tensor:
    """out[r, k, ...] = arr[nbr_idx[r,k], back[r,k], ...] where `mask`,
    else `old[r, k, ...]` (0 without `old`). `arr` must be a GLOBAL
    [R_total, K, ...] tensor (comm.all_robots'd). One row gather (K4) of
    the flattened [R*K, ...] table."""
    R, K = arr.shape[:2]
    idx = clip_idx(nbr_idx, R) * K + clip_idx(back, K)
    return gather_rows_pinned(arr.reshape(R * K, *arr.shape[2:]), idx, mask, old)


def gather_robot(arr: torch.Tensor, nbr_idx, mask) -> torch.Tensor:
    """out[r, k, ...] = arr[nbr_idx[r,k], ...], 0 where ~mask.
    `arr` must be a GLOBAL [R_total, ...] tensor (comm.all_robots'd). Plain
    indexing: the JAX package pins no layout around the gather of
    connectivity."""
    out = arr[clip_idx(nbr_idx, arr.shape[0])]
    return torch.where(expand_mask(mask, out.ndim - 2), out, torch.zeros_like(out))


def _delivered(state: SimState, gate: torch.Tensor, comm) -> tuple[torch.Tensor, torch.Tensor]:
    """(the peers' clipped global ids [R, K], the slots delivered [R, K]):
    both robots' gates hold and both slots are live. Symmetric in (r, j)."""
    gate_all = comm.all_robots(gate)
    src = clip_idx(state.nbr_idx, gate_all.shape[0])
    return src, gate[:, None] & state.nbr_mask & gate_all[src] & state.nbr_has_back


def sender_gate(state: SimState) -> torch.Tensor:
    """[R] bool: the robots that send in an external factor pass: active,
    antenna on and not idle."""
    return state.active & state.antenna & not_idle(state)


def sender_inputs(state: SimState, params: GbpParams, comm=LOCAL) -> dict:
    """The sender's message table's inputs (kernels/ir_slot.py) on the
    state's layout: seeded [R, K, V-1] bool, p_ext [R, K, V-1, 2], the
    snapshots [R, V, ...] (variables 1..V-1 are read), safety [R] and the
    global robot ids [R] in the state's dtype."""
    R = state.nbr_idx.shape[0]
    return dict(
        seeded=state.ir_int_seeded,
        p_ext=state.ir_v2f_ext_pos,
        snap_mu=state.snap_mu,
        snap_eta=state.snap_eta,
        snap_lam=state.snap_lam,
        safety=params.safety_distance_multiplier * state.radius,
        gids=comm.row_ids(R, state.device).to(state.prior_mean.dtype),
    )


# --------------------------------------------------------------------------
# the exchanges
# --------------------------------------------------------------------------

class Sender:
    """"sender": each robot computes its own factors' outbox; receivers
    gather it by (peer, reciprocal slot)."""

    name = "sender"

    def table_shape(self, params: GbpParams) -> tuple[int, ...]:
        """The per-robot table the external pass all-gathers: the outbox
        [K, V-1, 4]."""
        return (params.n_slots, params.n_vars - 1, 4)

    def launches(self, kernels: bool, cuda: bool) -> dict[str, int]:
        """Kernel launches an external slot: the message table (K3) on the
        kernels' path; a delivery and a response gather (K4) on the card."""
        return {"interrobot_slot": int(kernels), "gather_rows": 2 * int(cuda)}

    def new_factor_positions(self, state: SimState, nbr_idx: torch.Tensor,
                             is_new: torch.Tensor, comm=LOCAL) -> torch.Tensor:
        """[R, K, V-1, 2] each new factor's external linearisation point
        (robot.rs:1556-1566): the neighbour's current belief positions,
        variables 1..V-1 on chain slots 0..V-2."""
        return gather_robot(
            comm.all_robots(state.belief_mean[..., :2]), nbr_idx, is_new
        )[:, :, 1:, :]

    def horizon_mirrors(self, state: SimState, gate: torch.Tensor, new_mean: torch.Tensor,
                        comm=LOCAL) -> tuple[torch.Tensor, torch.Tensor]:
        """(ir_int_seeded, ir_v2f_ext_pos) after the horizon update under
        `gate` with the horizon's new mean [R, 4], at chain slot V-2: my
        factors' cavities there go live where my gate held, and each factor
        receives its peer's new horizon mean where the peer's gate held (an
        ungated receive, robot.rs:2272-2282)."""
        V = state.prior_mean.shape[1]
        gate_all = comm.all_robots(gate)
        src = clip_idx(state.nbr_idx, gate_all.shape[0])
        seeded = state.ir_int_seeded.clone()
        ir_v2f_ext_pos = state.ir_v2f_ext_pos.clone()
        seeded[:, :, V - 2] = torch.where(
            gate[:, None], state.nbr_mask, state.ir_int_seeded[:, :, V - 2]
        )
        sent = gate_all[src] & state.nbr_mask
        ir_v2f_ext_pos[:, :, V - 2] = torch.where(
            sent[..., None], comm.all_robots(new_mean)[src][..., :2],
            state.ir_v2f_ext_pos[:, :, V - 2],
        )
        return seeded, ir_v2f_ext_pos

    def seed_cavities(self, state: SimState, gate: torch.Tensor, comm=LOCAL) -> torch.Tensor:
        """`ir_int_seeded` after an internal variable pass under `gate`: a
        robot's own cavities of its live slots go live where its gate held."""
        return state.ir_int_seeded | (gate[:, None] & state.nbr_mask)[..., None]

    def factor_pass(self, state: SimState, params: GbpParams, comm=LOCAL,
                    kernels: bool = False) -> SimState:
        """Each robot computes the outbox `ir_f2v_ext` of its own factors
        where it produced (its gate and the slot hold), the old outbox
        elsewhere: one launch of the kernel of kernels/ir_slot.py on the
        kernels' path, its plain version elsewhere. r's inbox slot (r, k, i)
        receives from the factor owned by j = nbr_idx[r, k] at its
        reciprocal slot, where j produced this pass and r's antenna and
        mission gate hold, and keeps its old row elsewhere: one row gather
        (K4) with the old inbox."""
        send_gate = sender_gate(state)
        outbox = IR.interrobot_slot if kernels else IR.interrobot_slot_reference
        ir_f2v_ext = outbox(**sender_inputs(state, params, comm),
                            sigma=params.sigma_factor_interrobot, old=state.ir_f2v_ext,
                            send_gate=send_gate, nbr_mask=state.nbr_mask)
        # delivered implies a live slot, so the gather's mask is `deliver`
        _, deliver = _delivered(state, send_gate, comm)
        return replace(
            state,
            ir_f2v_ext=ir_f2v_ext,
            ext_inbox=gather_from_peer(comm.all_robots(ir_f2v_ext), state.nbr_idx,
                                       state.nbr_back, deliver, state.ext_inbox),
            iter_count_factor=state.iter_count_factor + send_gate.to(torch.int32),
        )

    def deliver_responses(self, state: SimState, gate: torch.Tensor, own_pos: torch.Tensor,
                          comm=LOCAL) -> torch.Tensor:
        """`ir_v2f_ext_pos` after the external variable pass under `gate`,
        with own_pos [R, V-1, 2] the new belief positions: the factor (r, k)
        receives j = nbr_idx[r, k]'s positions where delivered and keeps its
        old ones elsewhere, one row gather (K4) of the same positions for
        every reciprocal slot, with the old positions. The result is
        contiguous (see `_responses`)."""
        src, deliver = _delivered(state, gate, comm)
        return gather_rows_pinned(comm.all_robots(own_pos), src, deliver, state.ir_v2f_ext_pos)

    def reset_arrived(self, state: SimState, mask: torch.Tensor) -> dict:
        """The inter-robot fields of robots whose plan arrived (`mask` [R]):
        the robot's own rows hold its factors' state, so they are zeroed."""
        out = {}
        for k in ("ir_int_seeded", "ir_v2f_ext_pos", "ir_f2v_ext"):
            v = getattr(state, k)
            out[k] = torch.where(expand_mask(mask, v.ndim - 1), torch.zeros_like(v), v)
        return out


class Receiver:
    """"receiver": each receiver recomputes its incoming messages from the
    peers' gathered [V-1, 24] snapshot packs with the sender's rank-1 maths
    (bit-equal to "sender")."""

    name = "receiver"

    def table_shape(self, params: GbpParams) -> tuple[int, ...]:
        """The per-robot table the external pass all-gathers: the pack
        [V-1, 24]."""
        return (params.n_vars - 1, 24)

    def launches(self, kernels: bool, cuda: bool) -> dict[str, int]:
        """Kernel launches an external slot: the gather of the peers'
        tables (K4) on the card."""
        return {"gather_rows": int(cuda)}

    def new_factor_positions(self, state: SimState, nbr_idx: torch.Tensor,
                             is_new: torch.Tensor, comm=LOCAL) -> torch.Tensor:
        """The mirror: the PEER's new factor was seeded with MY current
        belief positions, so the mirror write is local."""
        return state.belief_mean[:, None, 1:, :2]

    def horizon_mirrors(self, state: SimState, gate: torch.Tensor, new_mean: torch.Tensor,
                        comm=LOCAL) -> tuple[torch.Tensor, torch.Tensor]:
        """The mirrors (magics_tpu state.py): the PEER's factor received MY
        new horizon mean where my gate held, and the PEER's seeded flag for
        its slot V-2 went true where ITS gate held."""
        V = state.prior_mean.shape[1]
        gate_all = comm.all_robots(gate)
        src = clip_idx(state.nbr_idx, gate_all.shape[0])
        seeded = state.ir_int_seeded.clone()
        ir_v2f_ext_pos = state.ir_v2f_ext_pos.clone()
        seeded[:, :, V - 2] |= gate_all[src] & state.nbr_has_back
        ir_v2f_ext_pos[:, :, V - 2] = torch.where(
            (gate[:, None] & state.nbr_has_back)[..., None],
            new_mean[:, None, :2],
            state.ir_v2f_ext_pos[:, :, V - 2],
        )
        return seeded, ir_v2f_ext_pos

    def seed_cavities(self, state: SimState, gate: torch.Tensor, comm=LOCAL) -> torch.Tensor:
        """The mirror: the peer's cavity for its reciprocal slot went live
        where ITS gate held."""
        gate_all = comm.all_robots(gate)
        src = clip_idx(state.nbr_idx, gate_all.shape[0])
        return state.ir_int_seeded | (gate_all[src] & state.nbr_has_back)[..., None]

    def factor_pass(self, state: SimState, params: GbpParams, comm=LOCAL,
                    kernels: bool = False) -> SimState:
        """Receiver-computes exchange (magics_tpu
        tick.py:_external_factor_pass_receiver): each receiver recomputes
        its incoming messages from a row gather of the peers' tables, the
        mirror of its own positions as held by the peer, and
        slot-deterministic tiny offsets. Plain operations on both paths.

        Its four parts are marked for a captured graph's map
        (`profiling.part`, each with its sizes R, K, V-1): `exchange.tables`
        (each robot's table), `exchange.gather` (the gates and the peers'
        rows), `exchange.messages` and `exchange.deliver` (the inbox and the
        counter)."""
        R, K = state.nbr_idx.shape
        V1 = state.prior_mean.shape[1] - 1
        f = state.prior_mean.dtype
        part = profiling.part

        part("exchange.tables", R, K, V1)
        tables = self._tables(state)

        part("exchange.gather", R, K, V1)
        send_gate = sender_gate(state)
        gate_all = comm.all_robots(send_gate)
        src = clip_idx(state.nbr_idx, gate_all.shape[0])
        width = tables.shape[-1]
        tables_all = comm.all_robots(tables).reshape(-1, V1 * width)
        peer = gather_rows_pinned(tables_all, src).reshape(R, K, V1, width)

        part("exchange.messages", R, K, V1)
        tiny, safety = CX.receiver_terms(src, state.nbr_back, comm.all_robots(state.radius),
                                         params.safety_distance_multiplier, V1)
        # the mirrors: the peer's cavity is present, my position as held by the peer
        msg = self._messages(peer, state.ir_int_seeded, state.ir_v2f_ext_pos, safety, tiny,
                             params.sigma_factor_interrobot, f)

        part("exchange.deliver", R, K, V1)
        deliver = send_gate[:, None] & state.nbr_mask & gate_all[src] & state.nbr_has_back
        out = replace(
            state,
            ext_inbox=torch.where(deliver[..., None, None], msg, state.ext_inbox),
            iter_count_factor=state.iter_count_factor + send_gate.to(torch.int32),
        )
        part(None)
        return out

    def _tables(self, state: SimState) -> torch.Tensor:
        """Each robot's snapshot pack [R, V-1, 24]: mean, eta, lambda."""
        R = state.nbr_idx.shape[0]
        V1 = state.prior_mean.shape[1] - 1
        return torch.cat(
            [state.snap_mu[:, 1:], state.snap_eta[:, 1:], state.snap_lam[:, 1:].reshape(R, V1, 16)],
            dim=-1,
        )

    def _messages(self, peer, seeded, p_ext, safety, tiny, sigma: float, f) -> torch.Tensor:
        """The sender's rank-1 messages [R, K, V-1, 4] from the peers' packs."""
        R, K, V1 = seeded.shape
        s3 = seeded[..., None]
        x_int = torch.where(s3, peer[..., 0:4], 0.0)
        cav_eta = torch.where(s3, peer[..., 4:8], 0.0)
        cav_lam = torch.where(s3[..., None], peer[..., 8:24].reshape(R, K, V1, 4, 4), 0.0)
        return F.interrobot_rank1_messages(
            x_int, p_ext, cav_eta, cav_lam, safety, tiny, sigma, dtype=f,
        )

    def deliver_responses(self, state: SimState, gate: torch.Tensor, own_pos: torch.Tensor,
                          comm=LOCAL) -> torch.Tensor:
        """The mirror of what the peer holds becomes MY new positions where
        delivered, with no gather."""
        _, deliver = _delivered(state, gate, comm)
        return _responses(state, deliver, own_pos[:, None])

    def reset_arrived(self, state: SimState, mask: torch.Tensor) -> dict:
        """The arrived robot's factor inboxes and seeded flags are MIRRORED
        on the rows of every peer whose slot points at it: those are zeroed.
        The robot's own rows (its position as held by peers) stay, as in the
        reference (peers keep the stale linearisation point until the next
        delivery)."""
        R = state.prior_mean.shape[0]
        src = state.nbr_idx.clamp(0, R - 1).long()
        peer_arrived = mask[src] & state.nbr_mask  # [R, K]
        out = {}
        for k in ("ir_int_seeded", "ir_v2f_ext_pos"):
            v = getattr(state, k)
            out[k] = torch.where(expand_mask(peer_arrived, v.ndim - 2), torch.zeros_like(v), v)
        return out


class ReceiverCompact(Receiver):
    """"receiver_compact": the mirror semantics of "receiver" over the
    peers' [V-1, 8] compact cavity tables; on the kernels' path two
    hand-written kernels (K5, kernels/compact_exchange.py)."""

    name = "receiver_compact"

    def table_shape(self, params: GbpParams) -> tuple[int, ...]:
        """The per-robot table the external pass all-gathers: the cavity
        tables [V-1, 8]."""
        return (params.n_vars - 1, 8)

    def launches(self, kernels: bool, cuda: bool) -> dict[str, int]:
        """Kernel launches an external slot: the two K5 kernels on the
        kernels' path on the card, else the gather of the peers' tables
        (K4) on the card."""
        compact = int(kernels and cuda)
        return {"gather_rows": int(cuda) - compact, "compact_table": compact,
                "compact_message": compact}

    def factor_pass(self, state: SimState, params: GbpParams, comm=LOCAL,
                    kernels: bool = False) -> SimState:
        """As "receiver" with the compact tables; on the kernels' path under
        the same four parts: `compact_table_kernel` (the tables, the send
        gates and the counter) in `exchange.tables`, the collectives of a
        `ShardComm` (none on one process) in `exchange.gather`,
        `compact_message_kernel` (the fresh inbox, reading the peers' table
        rows itself) in `exchange.messages`; `exchange.deliver` runs
        nothing."""
        if not kernels:
            return super().factor_pass(state, params, comm)
        R, K = state.nbr_idx.shape
        V1 = state.prior_mean.shape[1] - 1
        part = profiling.part

        part("exchange.tables", R, K, V1)
        tables, send_gate, count = CX.compact_tables(
            state.snap_mu, state.snap_eta, state.snap_lam, state.active, state.antenna,
            state.mission_active, state.completed, state.iter_count_factor)

        part("exchange.gather", R, K, V1)
        tables_all = comm.all_robots(tables)
        gate_all = comm.all_robots(send_gate)
        rad_all = comm.all_robots(state.radius)

        part("exchange.messages", R, K, V1)
        inbox = CX.compact_messages(
            tables_all, send_gate, gate_all, rad_all, state.nbr_idx, state.nbr_back,
            state.nbr_mask, state.nbr_has_back, state.ir_int_seeded, state.ir_v2f_ext_pos,
            state.ext_inbox, params.safety_distance_multiplier, params.sigma_factor_interrobot)

        part("exchange.deliver", R, K, V1)
        out = replace(state, ext_inbox=inbox, iter_count_factor=count)
        part(None)
        return out

    def _tables(self, state: SimState) -> torch.Tensor:
        """Each robot's compact cavity tables [R, V-1, 8]."""
        return F.compact_snap_tables(state.snap_mu, state.snap_eta, state.snap_lam,
                                     dtype=state.prior_mean.dtype)

    def _messages(self, peer, seeded, p_ext, safety, tiny, sigma: float, f) -> torch.Tensor:
        """The Sherman-Morrison messages [R, K, V-1, 4] from the peers'
        tables."""
        return F.interrobot_rank1_messages_compact(
            peer, seeded, p_ext, safety, tiny, sigma, dtype=f,
        )


def _responses(state: SimState, deliver: torch.Tensor, in_pos: torch.Tensor) -> torch.Tensor:
    """`ir_v2f_ext_pos` with `in_pos` where delivered. The result is
    contiguous, as the compact exchange's kernels read it, whatever the
    layout of the positions (in the hot loop a view of the robots-last
    planes, whose strides would otherwise set the `where`'s output
    layout)."""
    out = torch.empty_like(state.ir_v2f_ext_pos, memory_format=torch.contiguous_format)
    return torch.where(deliver[..., None, None], in_pos, state.ir_v2f_ext_pos, out=out)


#: the exchanges by their `GbpParams.ext_exchange` names
EXCHANGES = {e.name: e for e in (Sender(), Receiver(), ReceiverCompact())}


def exchange_of(params: GbpParams):
    """The exchange `params` asks for."""
    return EXCHANGES[params.ext_exchange]

"""The least work of one external slot's receiver-computes compact exchange
(magics_tpu_torch graph/tick.py:_external_factor_pass_receiver), counted
from its sizes and the state's masks as rooflines.slot_work counts a
slot's, so that its roofline reads the same work whatever implements it.

The bytes: each input read once for what needs it, each output written
once. Per robot, the gates the exchange reads (active, antenna,
mission_active, completed), its radius and its counter (read and
written); per robot and variable 1..V-1, its snapshot (mean, information
vector and precision) and its compact table (8 floats); per neighbour
slot, the neighbour tables (index, reciprocal slot, mask, reciprocity);
per delivered slot and variable, the two mirrors (the cavity's seeding and
the position the peer holds) and the inbox row written.

The operations, float32: per robot and variable the table (243: the
row-scaled cofactor inverse 211, that is row maxima 28, scales 8, scaling
16, 2x2 minors 36, determinant 11, adjugate 80, division 16 and unscaling
16; its checks 18; the two rows of C^-1 eta 14), per delivered slot and
variable the message (71: the tiny offset 6, the safety distance 1, the
measurement 22, J x0 and its residual 4, Sherman-Morrison 18, the guards
16, the masked message 4).
"""

from __future__ import annotations

F32 = 4
#: gates 4 x 1 byte, radius, the counter read and written
PER_ROBOT = 4 * 1 + F32 + 2 * 4
#: the snapshot's 4 + 4 + 16 floats and the table's 8
PER_ROBOT_VARIABLE = (24 + 8) * F32
#: nbr_idx and nbr_back (int32), nbr_mask and nbr_has_back (bool)
PER_SLOT = 2 * 4 + 2 * 1
#: ir_int_seeded (bool), ir_v2f_ext_pos (2 floats), the inbox row (4 floats)
PER_DELIVERED_VARIABLE = 1 + 2 * F32 + 4 * F32
TABLE_OPS = 243
MESSAGE_OPS = 71


def exchange_work(robots: int, slots: int, variables: int, delivered: int) -> tuple[int, int]:
    """(bytes, float32 operations) of one external slot's compact exchange
    of `robots` robots with `slots` neighbour slots each and `variables`
    external variables (V-1), where `delivered` (robot, slot) pairs
    receive a message."""
    nbytes = (robots * (PER_ROBOT + variables * PER_ROBOT_VARIABLE)
              + robots * slots * PER_SLOT
              + delivered * variables * PER_DELIVERED_VARIABLE)
    ops = robots * variables * TABLE_OPS + delivered * variables * MESSAGE_OPS
    return nbytes, ops


def delivered_of(state) -> int:
    """The (robot, slot) pairs a compact exchange delivers to at `state`:
    the robot and its peer send, the slot is live and reciprocal."""
    send = state.active & state.antenna & (state.mission_active | state.completed)
    src = state.nbr_idx.clamp(0, state.nbr_idx.shape[0] - 1).long()
    deliver = send[:, None] & state.nbr_mask & send[src] & state.nbr_has_back
    return int(deliver.sum())


def live_slots(out) -> int | None:
    """The live neighbour slots at the traced state, from the run's message
    line (its mean degree over its robots), or None where it has none."""
    for note in out.notes:
        if isinstance(note, dict) and "mean_degree" in note and "robots" in note:
            return round(note["mean_degree"] * note["robots"])
    return None

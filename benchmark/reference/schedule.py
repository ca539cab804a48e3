"""GBP iteration schedules (the port's own copy of magics_tpu/core/schedule.py).

Re-implements the five schedule strategies of the reference's `gbp_schedule`
crate (crates/gbp_schedule/src/schedules/*.rs). A schedule decides, for each of
the `max(internal, external)` micro-iterations inside one simulation timestep,
whether an internal (within-robot) and/or an external (inter-robot) GBP pass
runs.

Schedules are computed host-side as plain boolean lists; the jitted tick
treats them as static (they come from the scenario config and are fixed for a
simulation run).
"""

from __future__ import annotations

import enum


class ScheduleKind(str, enum.Enum):
    """Mirror of `GbpIterationScheduleKind` (crates/gbp_config/src/lib.rs:364-376)."""

    CENTERED = "centered"
    SOON_AS_POSSIBLE = "soon-as-possible"
    LATE_AS_POSSIBLE = "late-as-possible"
    INTERLEAVE_EVENLY = "interleave-evenly"
    HALF_BEGINNING_HALF_END = "half-beginning-half-end"


def _soon_as_possible(n: int, maximum: int) -> list[bool]:
    # crates/gbp_schedule/src/schedules/soon_as_possible.rs:26-49
    return [i < n for i in range(maximum)]


def _late_as_possible(n: int, maximum: int) -> list[bool]:
    # crates/gbp_schedule/src/schedules/late_as_possible.rs:31-50
    if n == maximum:
        return [True] * maximum
    if n == 0:
        return [False] * maximum
    return [i >= maximum - n for i in range(maximum)]


def _centered(n: int, maximum: int) -> list[bool]:
    # crates/gbp_schedule/src/schedules/centered.rs:19-48
    out = []
    for i in range(maximum):
        if n == 0 and maximum == 1:
            out.append(False)
            continue
        mid_point = maximum // 2
        half_n = n // 2
        start = mid_point - half_n if mid_point >= half_n else 0
        end = start + n - 1 if start + n <= maximum else maximum - 1
        out.append(start <= i <= end)
    return out


def _half_beginning_half_end(n: int, maximum: int) -> list[bool]:
    # crates/gbp_schedule/src/schedules/half_beginning_half_end.rs:19-45
    half_n = n // 2
    remainder = n % 2
    start_middle = half_n
    end_middle = maximum - half_n - remainder
    return [i < start_middle or i >= end_middle for i in range(maximum)]


def _interleave_evenly(n: int, maximum: int) -> list[bool]:
    # crates/gbp_schedule/src/schedules/interleave_evenly.rs:40-110 — recursive
    # even spread of n trues over `maximum` slots.
    seq = [False] * maximum
    _interleave_recurse(seq, n)
    return seq


def _interleave_recurse(slice_: list[bool], n: int) -> None:
    maximum = len(slice_)
    half = maximum // 2
    if n == maximum:
        for i in range(maximum):
            slice_[i] = True
    elif n == 0:
        for i in range(maximum):
            slice_[i] = False
    elif n % 2 == 1 and maximum % 2 == 1:
        if maximum % n == 0:
            times_divided = maximum // n
            for i in range(maximum):
                slice_[i] = i % times_divided == 0
        else:
            sub = n // 2
            left = slice_[:half]
            _interleave_recurse(left, sub)
            right = slice_[half + 1 :]
            _interleave_recurse(right, sub)
            right.reverse()
            slice_[:half] = left
            slice_[half] = True
            slice_[half + 1 :] = right
    elif n % 2 == 0 and maximum % 2 == 1:
        sub = n // 2
        left = slice_[:half]
        _interleave_recurse(left, sub)
        left.reverse()
        right = slice_[half + 1 :]
        _interleave_recurse(right, sub)
        slice_[:half] = left
        slice_[half] = False
        slice_[half + 1 :] = right
    elif n % 2 == 0 and maximum % 2 == 0:
        if maximum % n == 0:
            times_divided = maximum // n
            for i in range(maximum):
                slice_[i] = i % times_divided == 0
        else:
            sub = n // 2
            left = slice_[:half]
            _interleave_recurse(left, sub)
            right = slice_[half:]
            _interleave_recurse(right, sub)
            slice_[:half] = left
            slice_[half:] = right
    else:  # odd n, even maximum
        sub = n // 2
        left = slice_[:half]
        _interleave_recurse(left, sub + 1)
        left.reverse()
        right = slice_[half:]
        _interleave_recurse(right, sub)
        slice_[:half] = left
        slice_[half:] = right


_STRATEGIES = {
    ScheduleKind.SOON_AS_POSSIBLE: _soon_as_possible,
    ScheduleKind.LATE_AS_POSSIBLE: _late_as_possible,
    ScheduleKind.CENTERED: _centered,
    ScheduleKind.HALF_BEGINNING_HALF_END: _half_beginning_half_end,
    ScheduleKind.INTERLEAVE_EVENLY: _interleave_evenly,
}


def schedule_booleans(
    kind: ScheduleKind, internal: int, external: int
) -> list[tuple[bool, bool]]:
    """Return [(run_internal, run_external)] for each micro-iteration.

    Length is max(internal, external), matching `GbpScheduleParams::max`
    (crates/gbp_schedule/src/lib.rs:62-86).
    """
    maximum = max(internal, external)
    if maximum == 0:
        return []
    fn = _STRATEGIES[ScheduleKind(kind)]
    return list(zip(fn(internal, maximum), fn(external, maximum)))

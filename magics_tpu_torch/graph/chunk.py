"""A chunk of ticks captured as one CUDA graph: the port's counterpart of
`jax.jit(partial(run_ticks, n=n))` in the JAX package, which compiles n
ticks of `lax.scan` into one device program with no host work between
ticks.

    graph = compile_ticks(state, sdf, params, n)   # warm-up, then capture
    graph.replay()                                 # n ticks, no host work
    graph.state                                    # the state after them

`compile_ticks` keeps a static copy of the state, runs one eager chunk to
warm up (kernel plans, the slot kernels' shared-memory attribute, cached
constants) without touching that copy or the generator, and captures n
ticks of `tick.step` followed by `copy_state_` of the result back into the
static copy. Each `replay()` then advances the static state by n ticks.
`load(state)` re-seeds it by a device copy.

There is no fallback: a state off the card, a comm other than `LOCAL`
(a sharded tick's collectives are not captured), or a capture that fails,
raises. `tick.run_ticks` stays the eager loop. The kernels' host-side
launch counters count the launches made while capturing, once per chunk;
replays add nothing to them (`TickGraph.launches` keeps the capture's).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from magics_tpu_torch.graph import tick as T
from magics_tpu_torch.graph.state import GbpParams, SimState
from magics_tpu_torch.kernels import launch_counts
from magics_tpu_torch.parallel.comm import LOCAL, LocalComm


def clone_state(state: SimState) -> SimState:
    """A copy of `state` with every tensor cloned."""
    return dataclasses.replace(
        state, **{f.name: getattr(state, f.name).clone() for f in dataclasses.fields(state)}
    )


def copy_state_(dst: SimState, src: SimState) -> SimState:
    """Copy every field of `src` into the tensor of the same field of
    `dst`, in place: `dst`'s tensors keep their storage (a captured graph
    keeps reading and writing those addresses). A field of `src` that is
    `dst`'s own tensor is left as it is; one that shares storage with
    another field of `dst` is copied out first, so no copy reads what an
    earlier one wrote. Returns `dst`."""
    names = [f.name for f in dataclasses.fields(dst)]
    storages = {getattr(dst, n).untyped_storage().data_ptr() for n in names}
    pending = []
    for n in names:
        d, s = getattr(dst, n), getattr(src, n)
        if d.shape != s.shape or d.dtype != s.dtype or d.device != s.device:
            raise ValueError(f"{n}: {s.dtype} {tuple(s.shape)} on {s.device} does not fit "
                             f"{d.dtype} {tuple(d.shape)} on {d.device}")
        if s is d or s.numel() == 0:
            continue
        if s.untyped_storage().data_ptr() in storages:
            s = s.clone()
        pending.append((d, s))
    for d, s in pending:
        d.copy_(s)
    return dst


class TickGraph:
    """n ticks of `tick.step` captured as one CUDA graph over a static
    state (made by `compile_ticks`)."""

    def __init__(self, state, sdf, params, n, env_dist, comm, generator) -> None:
        self.state = clone_state(state)
        self.n = n
        # the graph reads these on every replay
        self._inputs = (sdf, env_dist, generator)
        self.graph = torch.cuda.CUDAGraph()

        # warm-up: one eager chunk on a side stream, from a copy of the
        # state, leaving the generator where it was
        g_state = generator.get_state() if generator is not None else None
        side = torch.cuda.Stream(device=state.device)
        side.wait_stream(torch.cuda.current_stream(state.device))
        with torch.cuda.stream(side):
            warm = T.run_ticks(clone_state(self.state), sdf, params, n, env_dist, comm, generator)
        torch.cuda.current_stream(state.device).wait_stream(side)
        torch.cuda.synchronize(state.device)
        del warm
        if generator is not None:
            generator.set_state(g_state)
            # each replay draws anew from the generator's advancing state
            self.graph.register_generator_state(generator)

        before = launch_counts()
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph):
            out = T.run_ticks(self.state, sdf, params, n, env_dist, comm, generator)
            copy_state_(self.state, out)
        torch.cuda.synchronize(state.device)
        self.capture_s = time.perf_counter() - t0
        after = launch_counts()
        #: kernel launches per chunk, counted while capturing
        self.launches = {k: after[k] - before.get(k, 0) for k in after}

    def replay(self) -> SimState:
        """Advance the static state by n ticks (queued on the current
        stream; nothing waits for the card). Returns the static state."""
        self.graph.replay()
        return self.state

    def load(self, state: SimState) -> SimState:
        """Re-seed the static state from `state` by a device copy."""
        return copy_state_(self.state, state)


def compile_ticks(
    state: SimState,
    sdf: torch.Tensor,
    params: GbpParams,
    n: int,
    env_dist: torch.Tensor | None = None,
    comm=LOCAL,
    generator: torch.Generator | None = None,
) -> TickGraph:
    """Capture n ticks as one CUDA graph (see the module docstring). The
    state must lie on the card; `generator` (on the card) drives the
    comms-failure draws where `comms_failure_rate > 0`."""
    if not isinstance(comm, LocalComm):
        raise ValueError(
            f"compile_ticks captures one process's ticks and takes the LOCAL comm, got "
            f"{comm!r}: a sharded tick's collectives are not captured (gloo's cannot be); "
            "run it eagerly with run_ticks (parallel/shard_tick.py:make_shard_step)"
        )
    if state.device.type != "cuda":
        raise RuntimeError(
            f"compile_ticks captures a CUDA graph and needs a state on the card (cuda), "
            f"got one on {state.device}; run_ticks runs the ticks eagerly on any device"
        )
    if n < 1:
        raise ValueError(f"n must be at least 1, got {n}")
    return TickGraph(state, sdf, params, n, env_dist, comm, generator)

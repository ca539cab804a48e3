"""Which gloo collectives take which tensors, between two processes: the
question behind the port's ranks that share one card (magics_tpu_torch/
parallel/; NCCL refuses two ranks on one device).

    python scripts/gloo_cuda_probe.py

For the CPU and, where there is a card, for `cuda:0`, two processes
('spawn', `file://` rendezvous) try `all_gather_into_tensor`, `all_gather`,
`all_reduce` and `reduce_scatter_tensor` on every dtype the tick's
collectives carry, and print one line each: ok with the first values, or
the error. Then the milliseconds of an 8 MB and a 64 MB (per rank)
`all_gather_into_tensor` of float32, mean of 3 after one warm call, host
clock ending in a synchronise. Exit code 0 unless a rank died.
"""

from __future__ import annotations

import multiprocessing
import sys
import tempfile
import time

import torch
import torch.distributed as dist

OPS = ("all_gather_into_tensor", "all_gather", "all_reduce", "reduce_scatter_tensor")
DTYPES = (torch.float32, torch.float64, torch.int32, torch.int64, torch.uint8, torch.bool)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _try(op: str, x: torch.Tensor, world: int) -> torch.Tensor:
    if op == "all_gather_into_tensor":
        out = x.new_empty((world * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x)
    elif op == "all_gather":
        outs = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(outs, x)
        out = torch.cat(outs)
    elif op == "all_reduce":
        out = x.clone()
        dist.all_reduce(out)
    else:
        out = torch.empty_like(x)
        dist.reduce_scatter_tensor(out, torch.cat([x] * world))
    return out


def rank_main(rank: int, world: int, init: str, device: str) -> None:
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    dev = torch.device(device)
    for op in OPS:
        for dt in DTYPES:
            x = (torch.arange(6, device=dev) + rank).to(dt).reshape(3, 2)
            try:
                out = _try(op, x, world)
                _sync(dev)
                res = f"ok {out.flatten().tolist()[:8]}"
            except (RuntimeError, ValueError, TypeError) as e:
                res = f"FAIL {type(e).__name__}: {str(e).splitlines()[0][:150]}"
            if rank == 0:
                print(f"{device} {op:24s} {str(dt):14s} {res}", flush=True)
    for mb in (8, 64):
        x = torch.ones(mb * 2**20 // 4, device=dev)
        out = x.new_empty(world * x.numel())
        dist.all_gather_into_tensor(out, x)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(3):
            dist.all_gather_into_tensor(out, x)
        _sync(dev)
        if rank == 0:
            print(f"{device} all_gather_into_tensor {mb} MB a rank: "
                  f"{(time.perf_counter() - t0) / 3 * 1e3:.1f} ms", flush=True)
    dist.destroy_process_group()


def main() -> int:
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0) if torch.cuda.is_available() else "no card", flush=True)
    ctx = multiprocessing.get_context("spawn")
    codes = []
    for device in ["cpu"] + (["cuda:0"] if torch.cuda.is_available() else []):
        with tempfile.TemporaryDirectory() as tmp:
            procs = [ctx.Process(target=rank_main, args=(r, 2, f"file://{tmp}/rdv", device))
                     for r in range(2)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(120)
                if p.is_alive():
                    p.kill()
                    p.join()
            codes += [p.exitcode for p in procs]
    return 0 if all(c == 0 for c in codes) else 1


if __name__ == "__main__":
    sys.exit(main())

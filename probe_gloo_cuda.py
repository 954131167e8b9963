#!/usr/bin/env python3
"""Which ``torch.distributed`` collectives a gloo world takes CUDA tensors
for, when its ranks share one card (``cuda:0``), and that a world of one
runs over NCCL.

    python3 probe_gloo_cuda.py

Two gloo ranks (a ``file://`` store in a temporary directory) try
``all_reduce``, ``broadcast``, ``all_gather_into_tensor``, ``all_gather``,
``reduce_scatter_tensor`` and ``batch_isend_irecv`` on a CUDA tensor and on
a CPU copy, one line each; then a 256 MB ``all_reduce`` of a CUDA tensor
direct and staged through host memory. A failing point-to-point call can
break the pair's connection, so the calls after it may fail too. Prints
the card's ``nvidia-smi`` line and torch's versions first.
"""
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist


def rank_main(rank, world, path):
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank, world_size=world)
    dev = torch.device("cuda:0")
    x = (torch.arange(1024., device=dev) + rank)
    def p2p(t):
        ops = [dist.P2POp(dist.isend, t, (rank + 1) % world), dist.P2POp(dist.irecv, torch.empty_like(t), (rank - 1) % world)]
        for r in dist.batch_isend_irecv(ops): r.wait()
    cases = [
        ("all_reduce", lambda t: dist.all_reduce(t.clone())),
        ("broadcast", lambda t: dist.broadcast(t.clone(), 0)),
        ("all_gather_into_tensor", lambda t: dist.all_gather_into_tensor(torch.empty(t.numel() * world, device=t.device), t)),
        ("all_gather", lambda t: dist.all_gather([torch.empty_like(t) for _ in range(world)], t)),
        ("reduce_scatter_tensor", lambda t: dist.reduce_scatter_tensor(torch.empty(t.numel() // world, device=t.device), t)),
        ("batch_isend_irecv", p2p),
    ]
    for name, fn in cases:
        for label, t in (("cuda", x), ("cpu", x.cpu())):
            try:
                fn(t); torch.cuda.synchronize(); ok = "ok"
            except Exception as e:
                ok = f"FAIL {type(e).__name__}: {str(e)[:160]}"
            print(f"rank{rank} {name} {label} {ok}", flush=True)
        dist.barrier()
    # rates: 256 MB all_reduce, CUDA tensor direct (if it works) and staged through pinned host memory
    n = 64 * 2**20
    big = torch.ones(n, device=dev)
    for label in ("cuda_direct", "host_staged"):
        try:
            dist.barrier(); torch.cuda.synchronize(); t0 = time.perf_counter()
            for _ in range(3):
                if label == "cuda_direct":
                    dist.all_reduce(big)
                else:
                    h = big.to("cpu"); dist.all_reduce(h); big.copy_(h)
            torch.cuda.synchronize(); dt = (time.perf_counter() - t0) / 3
            print(f"rank{rank} rate {label} all_reduce 256MB {dt*1e3:.1f} ms {n*4/dt/1e9:.2f} GB/s", flush=True)
        except Exception as e:
            print(f"rank{rank} rate {label} FAIL {type(e).__name__}: {str(e)[:120]}", flush=True)
    h = big.cpu(); out = torch.empty(n * world)
    dist.barrier(); t0 = time.perf_counter()
    dist.all_gather_into_tensor(out, h); dt = time.perf_counter() - t0
    print(f"rank{rank} rate cpu all_gather_into_tensor 256MB/rank {dt*1e3:.1f} ms", flush=True)
    dist.destroy_process_group()

def nccl_world_of_one(path):
    dist.init_process_group("nccl", init_method=f"file://{path}", rank=0, world_size=1, device_id=torch.device("cuda:0"))
    t = torch.ones(4, device="cuda:0"); dist.all_reduce(t); torch.cuda.synchronize()
    print("nccl world of one ok", t.tolist(), flush=True)
    dist.destroy_process_group()

if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "rank":
        rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]); sys.exit(0)
    if len(sys.argv) > 1 and sys.argv[1] == "nccl1":
        nccl_world_of_one(sys.argv[2]); sys.exit(0)
    print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    d = tempfile.mkdtemp()
    procs = [subprocess.Popen([sys.executable, __file__, "rank", str(r), "2", os.path.join(d, "store")]) for r in range(2)]
    rcs = [p.wait(timeout=300) for p in procs]
    print("gloo ranks rc", rcs, flush=True)
    p = subprocess.run([sys.executable, __file__, "nccl1", os.path.join(d, "store1")], timeout=120)
    print("nccl rc", p.returncode)
    import torch.distributed.device_mesh as dm
    print("device_mesh ok", hasattr(dm, "DeviceMesh"))

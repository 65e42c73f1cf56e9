"""``export_solver`` over a ``torch.distributed`` mesh of several ranks, each
rank on a card of its own: ``chip_smoke.py`` phases 7a and 7d's round trips
(its ``rank_dist_job`` and ``rank_seq_job``, at its settings) at a world of
``--world`` ranks (one NCCL rank a card; gloo with ``--device cpu``), and a
probe of which collectives gloo takes on the card's tensors.  Run from the
repository root (it imports ``chip_smoke.py``):

    python3 -m optimal_control_problem_tpu_torch.tools.rank_export \\
        [--world 4] [--device cuda|cpu] [--out chiprun_out/rank_export]
    python3 -m optimal_control_problem_tpu_torch.tools.rank_export --gloo-probe

Each rank exports ``DistributedSolver.solve_jit`` on the cart-pole h20
banded batch (B=1024, 2 SQP steps, cold; B1 inside) and the
sequence-parallel quadrotor h100 SQP (2 iterations, cold), leaves the
world, joins a new one, builds the same mesh, reloads its own program and
calls it beside the direct call; then the same calls over the in-process
mesh of 4 shards on its card, for the gap.  Prints one JSON object a
rank.  ``--device cpu`` runs small sizes (B=16, horizon 8): the
rehearsal.

``--gloo-probe``: four gloo ranks on the one card, each calling the
functional ``all_reduce`` (sum, max) and ``all_gather_into_tensor`` on
CUDA tensors, in that order; prints the last step each rank reached (a
crash ends the rank where it stands).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch


def _smoke():
    """``chip_smoke.py`` of the repository root: the jobs and settings."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke

    return chip_smoke


def _rank(rank, world, ports, device, out):
    cs = _smoke()
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank)
    B, horizon = (16, 8) if device == "cpu" else (1024, cs.SEQ_EXPORT["horizon"])
    case = dict(device=device, world=world, rank=rank, reps=0)
    runs = {"tick": cs.rank_dist_job(dict(case, B=B, ports=ports[:2],
                                          path=os.path.join(out, "tick.pt2"))),
            "sqp": cs.rank_seq_job(dict(cs.SEQ_EXPORT, **case, horizon=horizon,
                                        ports=ports[2:], path=os.path.join(out, "sqp.pt2")))}
    res = {name: {k: v for k, v in r.items() if k not in ("direct", "loaded")}
           for name, r in runs.items()}
    res["sqp"]["iters"] = runs["sqp"]["loaded"][1].tolist()
    res["sqp"]["status"] = runs["sqp"]["loaded"][2].astype(int).tolist()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _probe(rank, world, port, out):
    import torch.distributed as tdist

    def reached(step):
        with open(os.path.join(out, f"probe{rank}.txt"), "w") as f:
            f.write(step)

    torch.cuda.set_device(0)
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                             rank=rank)
    c10d = torch.ops._c10d_functional
    name = tdist.group.WORLD.group_name
    t = torch.arange(6, dtype=torch.float32, device="cuda") + rank
    steps = (("all_reduce sum", lambda: c10d.all_reduce(t, "sum", name)),
             ("all_reduce max", lambda: c10d.all_reduce(t, "max", name)),
             ("all_gather_into_tensor", lambda: c10d.all_gather_into_tensor(t, world, name)))
    for step, call in steps:
        reached(f"entered {step}")
        c10d.wait_tensor(call())
        torch.cuda.synchronize()
        reached(f"returned from {step}")
    tdist.destroy_process_group()


def main(argv=None) -> int:
    import torch.multiprocessing as mp

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--out", default=os.path.join("chiprun_out", "rank_export"))
    p.add_argument("--gloo-probe", action="store_true")
    a = p.parse_args(argv)
    os.makedirs(a.out, exist_ok=True)
    free_port = _smoke().free_port
    if a.gloo_probe:
        try:
            mp.spawn(_probe, args=(a.world, free_port(), a.out), nprocs=a.world, join=True)
        except mp.ProcessExitedException as e:
            print(f"a rank died: {e}")
        for r in range(a.world):
            print(json.dumps({"rank": r, "last_step": open(os.path.join(
                a.out, f"probe{r}.txt")).read()}))
        return 0
    if a.device == "cuda" and torch.cuda.device_count() < a.world:
        raise SystemExit(f"{a.world} ranks need {a.world} cards, not {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    mp.spawn(_rank, args=(a.world, tuple(free_port() for _ in range(4)), a.device, a.out),
             nprocs=a.world, join=True)
    for r in range(a.world):
        print(open(os.path.join(a.out, f"rank{r}.json")).read())
    print(json.dumps({"seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

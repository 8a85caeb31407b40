"""Planted faults against chip_smoke's data-parallel gates, on one card.

``chip_smoke.py``'s phase ``main_dp`` (a) holds two gloo ranks sharing one
card to one process: after the first step (loss, gradient norm, the update
of the parameters and of BatchNorm's running statistics) and over 16 steps
(the losses).  This script shows that those gates can fail: it runs (a)'s
one-process references and its honest two-rank runs (which must pass), the
one process's 16 steps once more (the card's own spread, reported), then
the two ranks once for each planted fault, each patched into the rank
processes at start-up (the repository's code is not changed), and holds
each to the same gates, which must fail.  A last check
trains with no process group twice and then in an NCCL group of one, in
one process with deterministic algorithms, ``--rounds`` times: the three
runs' losses must be bit-equal (batches come from blocks earlier runs
freed; the delivery's allocation fault showed there).

    python3 chip_dp_faults.py [--rounds N]

Prints one JSON line a run, then ``{"ok": ...}``; exits 1 when the honest
run fails a gate, a planted fault passes them all or a round differs.
Needs one card; writes its states under ``build/``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import chip_smoke as cs

ANCHOR = "from repro_torch.launch import train\n"
FAULTS = {
    # BatchNorm's global statistics with a backward that does not reduce:
    # each rank's gradient misses the other ranks' rows' terms
    "bn_backward_unreduced": (
        "from repro_torch.models import resnet\n"
        "resnet._GroupSum.backward = staticmethod(lambda ctx, g: g.clone())\n"),
    # the gradients summed over the ranks, not averaged
    "grad_reduce_not_divided": (
        "from repro_torch.launch import dist\n"
        "from repro_torch.train import steps\n"
        "_call = steps.GradReduce.__call__\n"
        "steps.GradReduce.__call__ = lambda self, grads: "
        "[g * dist.world_size() for g in _call(self, grads)]\n"),
    # the optimizer's update dropped on every rank alike
    "update_dropped": (
        "from repro_torch.train import optim, steps\n"
        "_make = steps.make_optimizer\n"
        "steps.make_optimizer = lambda *a, **k: optim.Optimizer(\n"
        "    _make(*a, **k).init, lambda grads, state, params, step: (params, state))\n"),
}
ROUNDS_CHILD = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.use_deterministic_algorithms(True)
torch.backends.cudnn.benchmark = False
from repro_torch.launch import train


def losses(args):
    return [h["loss"] for h in train.run(args).result.history]


plain = losses(sys.argv[3:])
again = losses(sys.argv[3:])
os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
group = losses(sys.argv[3:] + ["--dist-backend", "nccl", "--dist-init", sys.argv[2]])
print("ROUND " + json.dumps({"plain": plain, "plain_again": again, "nccl": group}), flush=True)
"""


def planted(fault: str) -> str:
    """chip_smoke's rank child with ``fault`` patched in after its imports."""
    if cs.DP_CHILD.count(ANCHOR) != 1:
        cs.fail("chip_dp_faults: the rank child's imports changed")
    return cs.DP_CHILD.replace(ANCHOR, ANCHOR + FAULTS[fault])


def summary(case: str, first: dict, run: dict, smi: str) -> dict:
    bad = cs.dp_gate(first, run)
    return {"case": case, "failures": bad, "passes_gates": not bad,
            "first_step": cs.dp_compare(first["one"], first["ranks"], first["gap"]),
            "first_step_tolerance_rel": cs.DP_FIRST_TOL,
            "run": cs.dp_compare(run["one"], run["ranks"], run["gap"]),
            "run_tolerance_rel_loss": cs.DP_TOL, "nvidia_smi": smi}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    sys.path.insert(0, str(cs.SRC))
    from repro_torch.kernels.ingest_norm import ops

    cs.build_all({"ingest_norm": ops.build})
    ok = True
    first, run = cs.dp_first_step("ranks"), cs.dp_run("ranks")
    honest = summary("honest", first, run, smi)
    honest["grad_allreduce_ms_per_step"] = (
        run["ranks"][0]["data_parallel"]["grad_allreduce_ms_per_step"])
    cs.emit(honest)
    ok &= honest["passes_gates"]
    # the card's own spread: the one process's 16 steps run again
    again, = cs.dp_runs([cs.dp_one_process("one_again", cs.DP_ARGS)], "one process again")
    cs.emit({"case": "one process again",
             "run": cs.dp_compare(run["one"], [again], cs.dp_state_gap("one_again", "one")),
             "nvidia_smi": smi})
    for fault in FAULTS:
        rec = summary(fault, cs.dp_first_step(fault, planted(fault), one=first["one"]),
                      cs.dp_run(fault, planted(fault), one=run["one"]), smi)
        cs.emit(rec)
        ok &= not rec["passes_gates"]
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    for i in range(args.rounds):
        out = subprocess.run([sys.executable, "-c", ROUNDS_CHILD, str(cs.SRC), cs.rendezvous_url(),
                              *cs.DP_NCCL_ARGS], capture_output=True, text=True, env=env,
                             timeout=300)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("ROUND ")]
        rec = json.loads(lines[-1][len("ROUND "):]) if lines else {"stderr": out.stderr[-3000:]}
        rec["bit_equal"] = bool(lines) and rec["plain"] == rec["plain_again"] == rec["nccl"]
        cs.emit(dict(rec, case=f"round {i}", nvidia_smi=smi))
        ok &= rec["bit_equal"]
    for path in cs.ROOT.glob("build/chip_smoke_dp_state_*.pt"):
        path.unlink()
    print(json.dumps({"ok": bool(ok)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

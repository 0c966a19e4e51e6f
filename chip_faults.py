#!/usr/bin/env python3
"""Faults planted in chip_smoke.py phase seqexpert's (a) and (b), to show that
their gradient check (SEQEXP_GRAD_REL) fails a wrong trunk.

    python3 chip_faults.py

Needs one CUDA card. Builds the kernels, then runs two gloo ranks on the
card, as the phase does. Rank 0 first runs the phase's one-rank fits. Then
both ranks run these fits, each with one fault patched in at run time (the
package on disk is not changed):

  no_seq_sum     (a) under ring: the Blocks' gradients not summed over seq
  own_keys       (a) under gather: k/v not gathered, so each rank attends
                 to its own tokens' keys alone
  no_expert_sum  (b): the MoE layer's f operator (the expert sum of its
                 input's and gates' gradients) skipped

Each fit prints the trunk's first-step gradient reading against one rank's,
and the phase's checks it fails are counted, not raised. The last line is
one JSON object {"faults": {name: reading}, "bound": SEQEXP_GRAD_REL,
"caught": bool}. The exit code is 0 when every reading is above the bound.
"""

import datetime
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs


def faults():
    """{name: (a function of (rank, raws, weights, refs) that runs the
    phase's fits it names and returns rank 0's result (None on rank 1), a
    function that patches the fault in and returns the function that takes
    it out)}."""
    import orbit2_tpu_torch.models.components.moe as moe
    import orbit2_tpu_torch.ops.seq_attention as sa
    import orbit2_tpu_torch.training.train as train

    def patch(module, name, value):
        def apply():
            saved = getattr(module, name)
            setattr(module, name, value)
            return lambda: setattr(module, name, saved)
        return apply

    def seq_under(impl):
        def run(rank, raws, weights, refs):
            saved, cs.SEQ_IMPL_DROP = cs.SEQ_IMPL_DROP, {impl: cs.SEQ_IMPL_DROP[impl]}
            try:
                return cs.seq_fits(rank, raws["seq"], weights["seq"], refs).get(f"seq_{impl}")
            finally:
                cs.SEQ_IMPL_DROP = saved
        return run

    def expert(rank, raws, weights, refs):
        return cs.expert_fit(rank, 2, raws["moe"], weights["moe"], refs).get("expert")

    return {"no_seq_sum": (seq_under("ring"), patch(train, "reduce_seq_grads", lambda m: None)),
            "own_keys": (seq_under("gather"), patch(sa, "gather_seq", lambda t, split: t)),
            "no_expert_sum": (expert, patch(moe, "copy_to_tensor", lambda x, group: x))}


def rank_main(rank: int, port: str, root: str):
    import torch.distributed as dist
    import yaml

    torch.cuda.set_device(0)
    raws = yaml.safe_load((Path(root) / "configs.yaml").read_text())
    weights = {"seq": cs.drawn_weights(cs.seqexp_config(raws["seq"], seq_par=1), cs.SEQEXP_SEED),
               "moe": cs.drawn_weights(cs.seqexp_config(raws["moe"], expert_par=1),
                                       cs.SEQEXP_SEED + 1)}
    refs = cs.one_rank_fits(raws["seq"], raws["moe"], weights["seq"], weights["moe"]) \
        if rank == 0 else {}
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=900))
    failed = []
    cs.check = lambda cond, msg: cond or failed.append(msg)
    readings = {}
    for name, (run, apply) in faults().items():
        undo = apply()
        try:
            result = run(rank, raws, weights, refs)
        finally:
            undo()
        if rank == 0:
            readings[name] = result["grad_rel"]
            print(f"  ({name}) the trunk's first-step gradients {result['grad_rel']:.3e} from "
                  f"one rank's (the worst parameter {result['grad_worst']}: "
                  f"{result['grad_param_rel']:.3e})", flush=True)
    if rank == 0:
        print("  (checks the faults failed) " + json.dumps(failed), flush=True)
        (Path(root) / "faults.json").write_text(json.dumps(readings))
    dist.barrier()
    dist.destroy_process_group()


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_faults: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libraries = {k.library.source.name: k.library for k in cs.kernels().values()}
    with ThreadPoolExecutor(len(libraries)) as pool:
        list(pool.map(lambda lib: lib.load(), libraries.values()))
    with tempfile.TemporaryDirectory() as tmp:
        import yaml

        root = Path(tmp)
        seq_raw, moe_raw = cs.seqexpert_configs(root, 0)
        (root / "configs.yaml").write_text(yaml.safe_dump({"seq": seq_raw, "moe": moe_raw}))
        env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
        port, t0 = str(cs.free_port()), time.perf_counter()
        procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), port, tmp],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=900)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        print("\n".join(line for line in logs[0].splitlines() if line.startswith("  (")))
        failed = [f"rank {r} exited {p.returncode}:\n{logs[r][-3000:]}"
                  for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            sys.exit("\n".join(failed))
        readings = json.loads((root / "faults.json").read_text())
    caught = all(v > cs.SEQEXP_GRAD_REL for v in readings.values())
    print(f"  {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"faults": readings, "bound": cs.SEQEXP_GRAD_REL, "caught": caught}))
    sys.exit(0 if caught else 1)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        main()

#!/usr/bin/env python3
"""Faults planted in chip_smoke.py's multi-rank checks, to show that their
bounds fail a wrong trunk: the gradient bound (SEQEXP_GRAD_REL), phase
servemesh's serving bounds and phase hubmesh's BatchNorm and mask checks.

    python3 chip_faults.py [seqexpert] [pipeline] [servemesh] [hubmesh]

Needs one CUDA card. Builds the kernels, then, for each phase named (every
one without arguments), runs two gloo ranks on the card, as the phase does.
Rank 0 first runs the phase's one-rank fits. Then both ranks run these
fits, each with one fault patched in at run time (the package on disk is
not changed):

  seqexpert:
  no_seq_sum          (a) under ring: the Blocks' gradients not summed over
                      seq
  own_keys            (a) under gather: k/v not gathered, so each rank
                      attends to its own tokens' keys alone
  no_expert_sum       (b): the MoE layer's f operator (the expert sum of
                      its input's and gates' gradients) skipped
  pipeline:
  unmasked_output     (a): the trunk's output summed over the stages
                      without the last-stage mask, every stage's slots in
  unsummed_embedding  (a): the trunk's input not summed over the stages in
                      the backward, so the later stage's embedding takes a
                      zero gradient
  servemesh:
  dropped_rows        (a) at fsdp 2: data rank 1's rows missing from each
                      gathered round
  no_row_sum          (a) at tensor 2: the row-parallel products' sum over
                      the tensor axis skipped (attention's projection, fc2)
  hubmesh:
  per_rank_statistics (a): each rank's BatchNorms normalise by its own
                      slice's statistics (the sum over the data ranks skipped)
  unfolded_dropout    (a): the ResidualBlocks' dropout seeds fold no data
                      coordinate, so both data ranks draw one mask

Each fit prints its first-step gradient reading against one rank's, each
serving run its readings against the one rank's (servemesh_phase's one
rank, run here first on weights drawn from trainer.seed, which the ranks
draw alike), and the phase's checks it fails are counted, not raised. The
last line is one JSON object {"faults": {name: reading}, "bound":
SEQEXP_GRAD_REL, "serving": {name: {failed checks, readings}}, "hub":
{name: {failed checks, readings}}, "caught": bool}. The exit code is 0 when
every gradient reading is above the bound and every serving and hub fault
fails a check of its phase.
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

PHASES = ("seqexpert", "pipeline", "servemesh", "hubmesh")


def patch(module, name, value):
    def apply():
        saved = getattr(module, name)
        setattr(module, name, value)
        return lambda: setattr(module, name, saved)
    return apply


def seqexpert_faults():
    """{name: (a function of (rank, raws, weights, refs) that runs the
    phase's fits it names and returns rank 0's result (None on rank 1), a
    function that patches the fault in and returns the function that takes
    it out)}."""
    import orbit2_tpu_torch.models.components.moe as moe
    import orbit2_tpu_torch.ops.seq_attention as sa
    import orbit2_tpu_torch.training.train as train

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


def pipeline_faults(root: Path):
    """The same for phase pipeline (a): each runs its gradient check."""
    import orbit2_tpu_torch.parallel.pipeline as pp

    def run(rank, raws, weights, refs):
        return cs.pp_grad_check(rank, raws["pipeline"], weights["pipeline"], refs["pipeline"],
                                root, "(fault)")

    stage_masks = pp.stage_masks

    def unmasked(split, device):
        first, _ = stage_masks(split, device)
        return first, torch.tensor(True, device=device)

    return {"unmasked_output": (run, patch(pp, "stage_masks", unmasked)),
            "unsummed_embedding": (run, patch(pp, "copy_to_tensor", lambda x, group: x))}


def servemesh_faults():
    """The same for phase servemesh (a): each serves its one mesh."""
    import orbit2_tpu_torch.evaluate as evaluate
    import orbit2_tpu_torch.models.components.blocks as blocks

    gather_rows = evaluate.gather_rows

    def first_rank_rows(tensors, real, mesh, device):
        (out, total) = gather_rows(tensors, real, mesh, device)
        mine = total // 2  # the rounds are full: each data rank holds half
        return [t[:mine] for t in out], mine

    def serve(mode):
        def run(rank, raws, weights, refs):
            return cs.servemesh_rank(rank, raws["root"], None, mode)[mode][0]
        return run

    return {"dropped_rows": (serve("fsdp"), patch(evaluate, "gather_rows", first_rank_rows)),
            "no_row_sum": (serve("tensor"), patch(blocks, "reduce_from_tensor",
                                                  lambda x, group: x))}


def hubmesh_faults():
    """The same for phase hubmesh (a): each runs the forecast fits."""
    import torch.distributed as dist

    import orbit2_tpu_torch.models.components.cnn as cnn

    def run(rank, raws, weights, refs):
        return cs.hubmesh_forecast(rank, refs, raws["root"])

    return {"per_rank_statistics": (run, patch(cnn, "all_reduce_sum",
                                               lambda x, group: x * dist.get_world_size(group))),
            "unfolded_dropout": (run, patch(cnn.ResidualBlock, "fold",
                                            property(lambda self: (), lambda self, v: None)))}


def rank_main(phase: str, rank: int, port: str, root: str):
    import torch.distributed as dist
    import yaml

    torch.cuda.set_device(0)
    root = Path(root)
    if phase == "servemesh":
        raws, weights, refs = {"root": root}, None, None
        faults = servemesh_faults()
    elif phase == "hubmesh":
        raws, weights = {"root": root}, None
        configs = yaml.safe_load((root / "configs.yaml").read_text())
        refs = cs.hubmesh_reference(configs, root) if rank == 0 else None
        faults = hubmesh_faults()
    elif phase == "seqexpert":
        raws = yaml.safe_load((root / "configs.yaml").read_text())
        weights = {"seq": cs.drawn_weights(cs.seqexp_config(raws["seq"], seq_par=1),
                                           cs.SEQEXP_SEED),
                   "moe": cs.drawn_weights(cs.seqexp_config(raws["moe"], expert_par=1),
                                           cs.SEQEXP_SEED + 1)}
        refs = cs.one_rank_fits(raws["seq"], raws["moe"], weights["seq"], weights["moe"]) \
            if rank == 0 else {}
        faults = seqexpert_faults()
    else:
        raws = {"pipeline": yaml.safe_load((root / "pipeline.yaml").read_text())}
        weights = {"pipeline": cs.drawn_weights(cs.pp_config(raws["pipeline"], pipeline=1,
                                                             pipeline_interleave=1), cs.PP_SEED)}
        refs = {"pipeline": cs.pp_reference(raws["pipeline"], weights["pipeline"], root)[1]
                if rank == 0 else None}
        faults = pipeline_faults(root)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=900))
    failed = []
    cs.check = lambda cond, msg: cond or failed.append(msg)
    readings = {}
    for name, (run, apply) in faults.items():
        undo = apply()
        try:
            result = run(rank, raws, weights, refs)
        finally:
            undo()
        if rank == 0 and phase == "hubmesh":
            drop0, drop = result["drop0"], result["drop"]
            readings[name] = {"failed": len(failed), "grad_rel": drop0["grad_rel"],
                              "stats_equal": [drop0["stats_equal"], drop["stats_equal"]],
                              "masks_differ": drop["masks_differ"]}
            failed.clear()
            print(f"  ({name}) {json.dumps(readings[name])}", flush=True)
        elif rank == 0 and phase == "servemesh":
            readings[name] = {"failed": len(failed), **{k: result[k] for k in (
                "pred_max_abs", "trunk_rel", "field_trunk_rel") if k in result},
                "metric_rel": max(result[q]["metric_rel"] for q in ("none", "w8a8")),
                "samples": result["none"]["samples"]}
            failed.clear()
            print(f"  ({name}) {json.dumps(readings[name])}", flush=True)
        elif rank == 0:
            readings[name] = result["grad_rel"]
            worst = (f"the worst parameter {result['grad_worst']}: "
                     f"{result['grad_param_rel']:.3e}" if "grad_worst" in result else
                     f"by part {json.dumps(result['readings'])}")
            print(f"  ({name}) the first-step gradients {result['grad_rel']:.3e} from one "
                  f"rank's ({worst})", flush=True)
    if rank == 0:
        print("  (checks the faults failed) " + json.dumps(failed), flush=True)
        (root / f"faults_{phase}.json").write_text(json.dumps(readings))
    dist.barrier()
    dist.destroy_process_group()


def run_phase(phase: str, root: Path):
    """Writes the phase's configs under `root`, runs its two ranks and
    returns rank 0's readings."""
    import yaml

    if phase == "hubmesh":
        cs.write_hubmesh_configs(root, 0)
    elif phase == "servemesh":
        from orbit2_tpu_torch.config import load_config
        from orbit2_tpu_torch.evaluate import Evaluator

        raws = cs.serve_raws(root, 0)
        for mode, raw in raws.items():
            (root / f"serve_{mode}.yaml").write_text(yaml.safe_dump(raw, sort_keys=False))
        cfgs = {mode: load_config(raw) for mode, raw in raws.items()}
        cs.serve_reference(Evaluator(cfgs["one"], "cuda"), cfgs, root)
        torch.cuda.empty_cache()
    elif phase == "seqexpert":
        seq_raw, moe_raw = cs.seqexpert_configs(root, 0)
        (root / "configs.yaml").write_text(yaml.safe_dump({"seq": seq_raw, "moe": moe_raw}))
    else:
        (root / "pipeline.yaml").write_text(yaml.safe_dump(cs.pipeline_raw(root / "data", 0)))
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    port = str(cs.free_port())
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", phase, str(r), port,
                               str(root)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
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
    return json.loads((root / f"faults_{phase}.json").read_text())


def main():
    phases = sys.argv[1:] or list(PHASES)
    unknown = set(phases) - set(PHASES)
    if unknown:
        sys.exit(f"chip_faults: unknown phases {sorted(unknown)} ({' | '.join(PHASES)})")
    if not torch.cuda.is_available():
        sys.exit("chip_faults: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libraries = {k.library.source.name: k.library for k in cs.kernels().values()}
    with ThreadPoolExecutor(len(libraries)) as pool:
        list(pool.map(lambda lib: lib.load(), libraries.values()))
    readings, serving, hub = {}, {}, {}
    t0 = time.perf_counter()
    for phase in phases:
        with tempfile.TemporaryDirectory() as tmp:
            {"servemesh": serving, "hubmesh": hub}.get(phase, readings).update(
                run_phase(phase, Path(tmp)))
    caught = (all(v > cs.SEQEXP_GRAD_REL for v in readings.values())
              and all(r["failed"] > 0 for r in (*serving.values(), *hub.values())))
    print(f"  {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"faults": readings, "bound": cs.SEQEXP_GRAD_REL, "serving": serving,
                      "hub": hub, "caught": caught}))
    sys.exit(0 if caught else 1)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        main()

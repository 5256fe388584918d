"""The readings that a cell's limits are set from, on the chip: for each
seed, the compared numbers of the system's served detections and of the
control, the reference put in the system's place one precision lower
(f32 configurations: TF32 on; int8 configurations: int4 codes), both
against the reference at the configuration's precision.

    python3 benchmark/tools/readings.py --workload <cell> \
        --seeds 11 12 13 [--control-seeds 11 12 13] [--out FILE]

The system serves each seed's sample of pool clouds through the same entry
and at the same batch as the cell's window (the stream: `infer` then
`to_host`, one frame at a time; a closed loop: the serving pipeline over
whole batches). A training cell's system takes its checked steps as a
run's set-up does; besides the control (TF32 on), its `--fault-seeds`
read the reference trained on half of each batch, the mean taken over the
rest (a step that returns its state unchanged reads 1 by the measure and
needs no run). One JSON line per seed and side.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import check, program, session  # noqa: E402
from benchmark.harness.inputs import sub_seed  # noqa: E402


def sample_indices(s):
    """Pool indices of a run-sized sample, whole requests."""
    tr = s.cell["traffic"]
    rng = np.random.default_rng(sub_seed(s.seed, 3))
    n_req = max(1, tr["sample_frames"] // s.batch)
    reqs = sorted(rng.choice(tr["pool"], min(n_req, tr["pool"]),
                             replace=False))
    return [int(r) for r in reqs]


def served(s, reqs):
    """The system's host detections of requests `reqs`, per frame."""
    tr = s.cell["traffic"]
    if tr["kind"] == "stream":
        dets = [program.to_host(s.infer(*s.request(k))) for k in reqs]
    else:
        pipe = program.pipeline(s.infer, tr["depth"])
        dets = list(pipe.map(s.request(k) for k in reqs))
    return [f for d in dets for f in check.split_frames(d)]


def as_served(ref_frame, class_offsets):
    """A reference frame's kept boxes in the served layout."""
    boxes, scores, labels = [], [], []
    for rb, rs, rl, kept, _ in ref_frame:
        boxes.append(rb[kept])
        scores.append(rs[kept])
        labels.append(rl[kept])
    b = torch.cat(boxes).float().cpu().numpy()
    return {"box3d_lidar": b, "scores": torch.cat(scores).float().cpu()
            .numpy(), "label_preds": torch.cat(labels).cpu().numpy(),
            "mask": np.ones(len(b), bool)}


def control_frames(s, idx):
    """The control's detections of pool frames `idx`."""
    mc = s.cell["config"]["model"]
    if session.is_quant(mc):
        ref = session.reference_for(s, qmax=7)
    else:
        program.set_tf32(True)
        ref = session.reference_for(s)
    try:
        frames = session.reference_frames(s, ref, idx)
    finally:
        program.set_tf32(False)
    return [as_served(f, session.class_offsets(mc)) for f in frames]


def train_rows(cell, seed, dev, system, control, fault):
    """A training cell's sides for one seed: [(side, readings)]."""
    from benchmark.harness import training

    s = training.TrainSetup(cell, seed, dev)
    rows = []
    if system:
        losses = []
        for k in range(cell["traffic"]["checked_steps"]):
            losses.append(float(s.step(s.feed(k))["loss"]))
            if k == 0:
                g1 = {n: g.detach().clone() for n, g in
                      training.first_moment_grads(s.opt, s.model).items()}
        after = {n: p.detach().clone() for n, p in
                 s.model.named_parameters()}
    del s.model, s.opt, s.step
    torch.cuda.empty_cache()
    ref = training.reference_run(s)
    if system:
        rows.append(("system", training.readings(s, losses, g1, after, ref)))
    if control:
        c = training.reference_run(s, tf32=True)
        rows.append(("control", training.readings(s, c[0], c[1], c[2], ref)))
    if fault:
        f = training.reference_run(s, rows=list(range(s.batch // 2)))
        rows.append(("half_batch", training.readings(s, f[0], f[1], f[2],
                                                     ref)))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = session.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    offsets = session.class_offsets(cell["config"]["model"])
    train = cell["traffic"]["kind"] == "train"
    for seed in sorted(set(args.seeds) | set(args.control_seeds)
                       | set(args.fault_seeds)):
        t = time.perf_counter()
        if train:
            for side, values in train_rows(
                    cell, seed, dev, seed in args.seeds,
                    seed in args.control_seeds, seed in args.fault_seeds):
                line = dict(workload=args.workload, seed=seed, side=side,
                            **values, seconds=time.perf_counter() - t)
                print(json.dumps(line), flush=True)
                if out:
                    out.write(json.dumps(line) + "\n")
                    out.flush()
            torch.cuda.empty_cache()
            continue
        s = session.Setup(cell, seed, dev)
        reqs = sample_indices(s)
        idx = [r * s.batch + b for r in reqs for b in range(s.batch)]
        rows = []
        if seed in args.seeds:
            got = served(s, reqs)
            rows.append(("system", got))
        del s.model, s.infer
        torch.cuda.empty_cache()
        if seed in args.control_seeds:
            rows.append(("control", control_frames(s, idx)))
        program.set_tf32(False)
        ref = session.reference_frames(s, session.reference_for(s), idx)
        for side, frames in rows:
            line = dict(workload=args.workload, seed=seed, side=side,
                        frames=len(frames),
                        **check.readings(frames, ref, offsets),
                        seconds=time.perf_counter() - t)
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
        del s
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the system and the reference part, layer by layer, on the chip.

    python3 benchmark/tools/diagnose.py --workload <cell> --seeds 5 6 5

For each seed in the order given (a seed may repeat, to see whether the
first in a process reads differently), the system serves the run-sized
sample at the cell's batch while hooks keep its reader, backbone, neck and
head outputs; the reference computes the same frames; per layer the
largest difference and the share of elements that differ are printed,
then the readings of the system's head outputs decoded and suppressed by
the reference (is the difference in the forward, or in decode and NMS?)
and the system's own detections. One JSON line per seed.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

from benchmark.harness import check, program, session  # noqa: E402
from benchmark.tools.readings import sample_indices, served  # noqa: E402


def _diff(a, b):
    a, b = a.float(), b.float()
    d = (a - b).abs()
    return {"max": float(d.max()), "share": float((d > 0).float().mean()),
            "scale": float(b.abs().max())}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = session.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    offsets = session.class_offsets(cell["config"]["model"])
    for seed in args.seeds:
        s = session.Setup(cell, seed, dev)
        reqs = sample_indices(s)
        idx = [r * s.batch + b for r in reqs for b in range(s.batch)]
        kept = {}

        def keep(name):
            def hook(module, inputs, out):
                kept.setdefault(name, []).append(out)
            return hook

        m = s.model
        hs = [m.reader_net.register_forward_hook(keep("reader")),
              m.backbone_net.register_forward_hook(keep("backbone")),
              m.neck_net.register_forward_hook(keep("neck")),
              m.head_net.register_forward_hook(keep("head"))]
        got = served(s, reqs)
        for h in hs:
            h.remove()
        head = [{k: torch.cat([r[t][k] for r in kept["head"]]).float()
                 for k in kept["head"][0][t]}
                for t in range(len(kept["head"][0]))]
        program.set_tf32(False)
        ref = session.reference_for(s)
        pts = s.pool_pts[torch.tensor(idx)].to(dev)
        msk = s.pool_msk[torch.tensor(idx)].to(dev)
        out = {"seed": seed}
        with torch.no_grad():
            grid, occ = ref.reader(pts, msk)
            g_sys = torch.cat([r[0] for r in kept["reader"]])
            out["reader"] = _diff(g_sys.permute(0, 3, 1, 2), grid)
            feats = ref.backbone(grid, occ)
            for k in ("conv2", "conv3", "conv4", "conv5"):
                sys_k = torch.cat([r[k][0] for r in kept["backbone"]])
                out[k] = _diff(sys_k, feats[k])
            neck = ref.neck(feats)
            out["neck"] = _diff(torch.cat([r[0] for r in kept["neck"]]),
                                neck)
            preds = ref.head(neck)
            for t, (a, b) in enumerate(zip(head, preds)):
                out[f"head{t}"] = {k: _diff(a[k], b[k])["max"] for k in b}
            frames = session.reference_frames(s, ref, idx)
            # the system's head outputs decoded and suppressed by the
            # reference: compared with the system's own detections
            dec = ref.decode(head)
            mine = [[(bx[b], sc[b], lb[b], ref.nms(bx[b], sc[b], lb[b]),
                      cs[b]) for bx, sc, lb, cs in dec]
                    for b in range(len(idx))]
        out["system_vs_reference"] = check.readings(got, frames, offsets)
        out["system_vs_its_outputs_by_reference_nms"] = check.readings(
            got, mine, offsets)
        print(json.dumps(out), flush=True)
        del s, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

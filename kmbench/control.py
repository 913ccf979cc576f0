"""Readings for the limits of ``correct``: the program's numbers over
many seeds, and the control's, the plain reference computed one precision
below the configuration's (float32 -> TF32, bfloat16 -> fp8 e4m3) and put
in the program's place, at the cell's own size.

    python3 kmbench/control.py --workload <name> --program-seeds 1,2,3 \\
        --control-seeds 4,5,6

One process, one call a seed (no window), each judged as a run judges
its calls.  Prints one JSON line a seed and, last, for each number the
largest program reading and the smallest control reading.  The
benchmark's own runs never run this.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

from kmbench import harness as H  # noqa: E402


def readings(cell, seeds, program, device, side):
    out = []
    for seed in seeds:
        t = time.perf_counter()
        res = H.run_cell(cell, seed, 0, False, program, device, t, warm=False)
        nums = {k: v["value"] for k, v in res["checks"].items()}
        line = {"side": side, "seed": seed, "correct": res["correct"],
                "seconds": time.perf_counter() - t, "checks": nums}
        print(json.dumps(line), flush=True)
        out.append(nums)
    return out


def main(argv, root=ROOT, device=None, program=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default="",
                    help="read the program with this fault planted "
                    "(faults.FAULTS) on the control seeds too")
    ap.add_argument("--precision", default=None,
                    help="the control's precision (default: one below the "
                    "configuration's)")
    ap.add_argument("--no-control", action="store_true",
                    help="read no control: the control seeds serve the "
                    "faults alone")
    args = ap.parse_args(argv)
    import torch
    cell = H.find_cell(root, args.workload)
    if device is None:
        if not torch.cuda.is_available():
            print("control: no CUDA card", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.program_seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    prec = args.precision or H.LOWER[cell.config["dtype"]]
    prog = readings(cell, seeds, program or H.Program(), device, "program")
    ctrl = ([] if args.no_control else
            readings(cell, cseeds, H.ReferenceProgram(prec), device,
                     "control " + prec))
    for fault in [f for f in args.fault.split(",") if f]:
        from kmbench.faults import Broken
        readings(cell, cseeds, Broken(fault), device, "fault " + fault)
    names = sorted({k for r in prog + ctrl for k in r})
    summary = {}
    for k in names:
        p = [r[k] for r in prog if isinstance(r.get(k), (int, float))]
        c = [r[k] for r in ctrl if isinstance(r.get(k), (int, float))]
        summary[k] = {"program_max": max(p) if p else None,
                      "control_min": min(c) if c else None}
    print(json.dumps({"summary": summary, "workload": cell.name,
                      "control_precision": prec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

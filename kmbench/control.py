"""Readings for the limits of ``correct``: the program's numbers over
many seeds, and the control's, the plain reference computed one precision
below the configuration's (float32 -> TF32, bfloat16 -> fp8 e4m3) and put
in the program's place, at the cell's own size (``harness.control_program``:
over several cards, the program's call with its last assignment computed
again in that precision).

    python3 kmbench/control.py --workload <name> --program-seeds 1,2,3 \\
        --control-seeds 4,5,6 [--fault half,moved=5/6]

One process, one call a seed (no window), each judged as a run judges
its calls.  A seed's data is made once for every side that reads it, and
a call the program has made on it is not made again: a control or a
fault that starts from the program's call takes the one already made (a
fault planted inside the program, ``faults.INSIDE``, makes its own).
Prints one JSON line a reading and, last, for each number the largest
program reading and the smallest control reading.  The benchmark's own
runs never run this.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

from kmbench import harness as H  # noqa: E402


class Calls:
    """The program's k-means calls on one seed's data, kept by their
    arguments: a call made again gives the kept result and prints its
    lines again."""

    def __init__(self, fn):
        self.fn, self.kept = fn, {}

    def __call__(self, x, k, **kw):
        key = (k, tuple(sorted(kw.items())))
        if key not in self.kept:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                out = self.fn(x, k, **kw)
            self.kept[key] = (out, buf.getvalue())
        out, text = self.kept[key]
        print(text, end="")
        return out


def reading(cell, seed, program, devices, side, x):
    t = time.perf_counter()
    res = H.run_cell(cell, seed, 0, False, program, devices, t, warm=False,
                     x=x)
    nums = {k: v["value"] for k, v in res["checks"].items()}
    print(json.dumps({"side": side, "seed": seed, "correct": res["correct"],
                      "seconds": time.perf_counter() - t, "checks": nums}),
          flush=True)
    return nums


def main(argv, root=ROOT, device=None, program=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default="",
                    help="read the program with these faults planted "
                    "(faults.FAULTS) on the control seeds too; "
                    "name=seed/seed on those of them alone")
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
        devices = [torch.device("cuda", i) for i in range(cell.chips)]
    else:
        devices = [device] * cell.chips
    seeds = [int(s) for s in args.program_seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    faults = {}
    for item in filter(None, args.fault.split(",")):
        name, _, only = item.partition("=")
        faults[name] = ({int(s) for s in only.split("/")} if only
                        else set(cseeds))
    prec = args.precision or H.LOWER[cell.config["dtype"]]
    from kmbench.faults import INSIDE, Broken
    prog, ctrl, broken = [], [], {}
    x = None
    for seed in dict.fromkeys(seeds + cseeds):
        # one seed's samples at a time; host samples keep their memory
        if cell.chips == 1:
            x = None
        x = H.cell_samples(cell, seed, devices, out=x)
        sides = [("program", program or H.Program())] if seed in seeds \
            else []
        if seed in cseeds:
            if not args.no_control:
                sides.append(("control " + prec, H.control_program(
                    cell, devices, prec)))
            sides += [("fault " + f, Broken(f, devices))
                      for f, on in faults.items() if seed in on]
        calls = None
        for side, p in sides:
            if isinstance(p, H.Program):
                fn = p.kmeans_fn
                fn = fn.fn if isinstance(fn, Calls) else fn
                if getattr(p, "fault", None) in INSIDE:
                    p.kmeans_fn = Calls(fn)
                else:
                    calls = calls or Calls(fn)
                    p.kmeans_fn = calls
            nums = reading(cell, seed, p, devices, side, x)
            if side == "program":
                prog.append(nums)
            elif side.startswith("control"):
                ctrl.append(nums)
            else:
                broken.setdefault(p.fault, []).append(nums)
    def read(rows, k, pick):
        v = [r[k] for r in rows if isinstance(r.get(k), (int, float))]
        return pick(v) if v else None

    names = sorted({k for r in prog + ctrl + sum(broken.values(), [])
                    for k in r})
    summary = {k: {"program_max": read(prog, k, max),
                   "control_min": read(ctrl, k, min),
                   "faults_min": {f: read(r, k, min)
                                  for f, r in broken.items()}}
               for k in names}
    print(json.dumps({"summary": summary, "workload": cell.name,
                      "control_precision": prec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

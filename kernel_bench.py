#!/usr/bin/env python3
"""Device and wrapper times of the port's CUDA kernels in several checkouts,
measured in turns on one NVIDIA GPU.

Run from the root of a checkout:

  python3 kernel_bench.py DIR [DIR ...]

Each DIR holds another checkout of the port (at least iqc_tpu_torch/), for
example an earlier commit unpacked with `git archive`, or a copy whose
kernel sources differ in a design constant. First every tree's kernel
library is built, all builds started together. Then every tree is measured
twice, in the order DIR..., this checkout, this checkout, ...DIR, each time
in a process of its own that imports that tree's package. A measurement
checks K1-K3 for exact equality with their plain versions and times them at
the shapes of one predict and of predict_batch of 8 (chip_smoke.SHAPES):
device ms (chip_smoke.graph_ms, a CUDA graph of raw launches) and wrapper ms
(chip_smoke.cuda_time_ms). For K1 at the predict shape it also times the
launch with no round, which splits the IoU triangle from the rounds. Prints
a table, the nvidia-smi line and one JSON line last; needs a CUDA device.

K1's raw entry point is launched in the measured tree's own form, read from
that tree's ``build._SIGNATURES["iqc_suppress"]``: the IoU threshold as a
pointer to a float32 on the device (this checkout) or as a C float (older
trees, whose wrapper also takes the threshold as a float). A tree with
another form is refused.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))


def import_tree(tree):
    """The package of `tree`, imported ahead of any other checkout's."""
    sys.path.insert(0, os.path.abspath(tree))
    import iqc_tpu_torch

    here = os.path.dirname(os.path.abspath(iqc_tpu_torch.__file__))
    if here != os.path.join(os.path.abspath(tree), "iqc_tpu_torch"):
        raise SystemExit(f"imported {here}, not the port in {tree}")
    from iqc_tpu_torch import build

    return build


_P, _I = ctypes.c_void_p, ctypes.c_int
# K1's entry point: the threshold as a device pointer, or as a C float
K1_FORMS = {(_P, _P, _P, _I, _I, _I, _P): "pointer",
            (_P, _P, _I, _I, ctypes.c_float, _I, _P): "float"}


def k1_form(build, tree):
    form = K1_FORMS.get(tuple(build._SIGNATURES["iqc_suppress"]))
    if form is None:
        raise SystemExit(f"{tree}: K1's entry point has a form this script does not know: "
                         f"{build._SIGNATURES['iqc_suppress']}")
    return form


def k1_launch(torch, fn, form, boxes, thr, keep, iterations):
    """A launch of K1's raw entry point in the tree's form; `thr` is a 0-d
    float32 tensor on the card."""
    b, k = boxes.shape[:2]
    if form == "pointer":
        args = (boxes.data_ptr(), thr.data_ptr(), keep.data_ptr(), b, k, iterations)
    else:
        args = (boxes.data_ptr(), keep.data_ptr(), b, k, float(thr.item()), iterations)

    def launch():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SystemExit(f"iqc_suppress failed with CUDA error {err}")
    return launch


def measure(tree):
    import torch

    build = import_tree(tree)
    form = k1_form(build, tree)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda")
    lib = build.library()
    out = {}
    from iqc_tpu_torch.ops import nms_kernel

    for label, images, rois in smoke.SHAPES:
        for c in smoke.kernel_cases(torch, dev, images, rois):
            if c["name"] == "suppress":
                boxes, thr, keep = c["raw"].tensors[:3]
                c["raw"] = k1_launch(torch, lib.fns["iqc_suppress"], form, boxes, thr, keep,
                                     smoke.ROUNDS)
                if form == "float":
                    c["wrapper"] = lambda b=boxes: nms_kernel.suppress(b, smoke.THRESHOLD,
                                                                       smoke.ROUNDS)
                    c["plain"] = lambda b=boxes: nms_kernel.suppress_plain(b, smoke.THRESHOLD,
                                                                           smoke.ROUNDS)
            err = smoke.max_err(torch, c["wrapper"](), c["plain"]())
            smoke.check(err == 0, f"{tree}: {c['name']} {c['shape']} differs from its plain version")
            out[f"{c['name']} {label} {c['shape']}"] = {
                "device_ms": smoke.graph_ms(torch, c["raw"]),
                "wrapper_ms": smoke.cuda_time_ms(c["wrapper"])}
    boxes = smoke.nms_inputs(torch, dev, batch=1)
    keep = torch.empty(boxes.shape[:2], dtype=torch.bool, device=dev)
    thr = torch.tensor(smoke.THRESHOLD, dtype=torch.float32, device=dev)
    no_rounds = k1_launch(torch, lib.fns["iqc_suppress"], form, boxes, thr, keep, 0)
    out[f"suppress request [1,{boxes.shape[1]},4] no round ({form} threshold)"] = {
        "device_ms": smoke.graph_ms(torch, no_rounds)}
    print(json.dumps(out), flush=True)


def child(mode, tree):
    return [sys.executable, os.path.abspath(__file__), mode, tree]


def compare(dirs):
    trees = [os.path.abspath(d) for d in dirs] + [REPO]
    builds = [subprocess.Popen(child("--build", t)) for t in trees]
    for t, proc in zip(trees, builds):
        if proc.wait(timeout=600) != 0:
            raise SystemExit(f"build of {t} failed ({proc.returncode})")
    runs = {t: [] for t in trees}
    for t in trees + trees[::-1]:
        proc = subprocess.run(child("--measure", t), capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:])
            raise SystemExit(f"measure of {t} failed ({proc.returncode})")
        runs[t].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    table = {}
    for t in trees:
        name = "this" if t == REPO else os.path.relpath(t, REPO)
        table[name] = {case: {metric: [run[case][metric] for run in runs[t]]
                              for metric in runs[t][0][case]}
                       for case in runs[t][0]}
        for case, row in table[name].items():
            print(f"{name:28s} {case:36s} "
                  + "; ".join(f"{m} {' '.join(f'{v:.5f}' for v in vs)}" for m, vs in row.items()))
    return table


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="*", help="other checkouts of the port")
    ap.add_argument("--build", metavar="TREE", help=argparse.SUPPRESS)
    ap.add_argument("--measure", metavar="TREE", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", flush=True)
        return 1
    if args.build:
        import_tree(args.build).library()
        return 0
    if args.measure:
        measure(args.measure)
        return 0
    print(f"device {torch.cuda.get_device_name(0)}, torch {torch.__version__}", flush=True)
    table = compare(args.dirs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"trees": table, "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

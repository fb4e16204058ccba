"""Multi-pod dry-run: count every (arch x shape) cell on the production mesh
and record memory / cost / collective analysis (counterpart of
``repro.launch.dryrun``).

The reference AOT-compiles each cell for 512 placeholder host devices and
parses the HLO.  Eager PyTorch compiles nothing, so here one rank
(coordinate 0 on every axis) of a ``RecordingMesh`` runs one step on
``meta`` tensors under ``launch.cost.analyze``: a host analysis that
touches no device.  Every number it writes is modelled -- FLOPs, bytes and
wire bytes from shapes, the roofline terms from ``core.hardware.H100``'s
data-sheet constants -- not measured.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --isolate
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

from repro_torch import configs
from repro_torch.core.hardware import H100
from repro_torch.launch import cells as C
from repro_torch.launch.cost import RecordingMesh
from repro_torch.launch.roofline import roofline_terms

DEFAULT_OUT = "results/torch_dryrun"


def cell_path(out_dir: str, mesh_name: str, arch: str, shape: str) -> str:
    return os.path.join(out_dir, mesh_name, f"{arch}__{shape}.json")


def production_mesh(multi_pod: bool) -> RecordingMesh:
    """One rank of the 16x16 pod or the 2x16x16 multi-pod mesh."""
    if multi_pod:
        return RecordingMesh((2, 16, 16), ("pod", "data", "model"))
    return RecordingMesh((16, 16), ("data", "model"))


def run_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool,
    out_dir: str = DEFAULT_OUT,
    save_ops: bool = False,
    train_overrides: dict | None = None,
    options: dict | None = None,
    tag: str = "",
) -> dict:
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    path = cell_path(out_dir, mesh_name, arch + tag, shape_name)
    os.makedirs(os.path.dirname(path), exist_ok=True)

    cfg = configs.get_config(arch)
    shape = configs.get_shape(shape_name)
    ok, reason = configs.shape_applicable(cfg, shape)
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "kind": shape.kind}
    if not ok:
        record["skipped"] = reason
        with open(path, "w") as f:
            json.dump(record, f, indent=2)
        print(f"[dryrun] SKIP {arch} x {shape_name} ({mesh_name}): {reason}")
        return record

    mesh = production_mesh(multi_pod)
    t0 = time.time()
    cell = C.build_cell(arch, shape_name, mesh, train_overrides=train_overrides,
                        options=options)
    t_build = time.time() - t0
    t0 = time.time()
    counted = cell.count(table=save_ops)
    t_count = time.time() - t0
    ops_table = counted.pop("ops", None)
    mem = counted.pop("memory")
    roof = roofline_terms(parsed=counted, n_devices=mesh.n_devices,
                          model_flops=C.model_flops(cell.cfg, shape))
    print(f"[dryrun] {arch} x {shape_name} ({mesh_name}), one rank on meta "
          f"(modelled, {H100.name} constants)")
    print(f"  memory: peak {mem['peak_bytes_per_device'] / 1e9:.2f} GB "
          f"(arguments {mem['argument_size_in_bytes'] / 1e9:.2f} GB)")
    print("  counted: flops/device=%.3e bytes/device=%.3e launches=%d"
          % (counted["flops"], counted["bytes_accessed"], counted["launches"]))
    print(f"  roofline: compute={roof.compute_s*1e3:.2f}ms memory={roof.memory_s*1e3:.2f}ms"
          f" collective={roof.collective_s*1e3:.2f}ms -> dominant={roof.dominant}"
          f" useful_flops_ratio={roof.useful_flops_ratio:.3f}")
    for op, v in sorted(counted["collectives"].items()):
        print(f"    {op:20s} n={v['count']:6.0f} result={v['result_bytes']/1e6:10.1f}MB"
              f" wire={v['wire_bytes']/1e6:10.1f}MB groups={v['group_sizes']}")

    record.update(
        n_devices=mesh.n_devices,
        build_s=round(t_build, 2),
        count_s=round(t_count, 2),
        memory=mem,
        cost=counted,
        roofline=roof.as_dict(),
        hbm_ok=bool(mem["peak_bytes_per_device"] <= H100.hbm_bytes),
        hardware=H100.name,
        train_overrides=train_overrides or {},
        options=options or {},
    )
    if save_ops:
        ops_path = path.replace(".json", ".ops.json")
        with open(ops_path, "w") as f:
            json.dump(ops_table, f, indent=1, sort_keys=True)
        record["ops_path"] = ops_path
    with open(path, "w") as f:
        json.dump(record, f, indent=2)
    return record


def _run_isolated(arch, shape, mesh_flag, out_dir, save_ops) -> int:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
           "--mesh", mesh_flag, "--out", out_dir]
    if save_ops:
        cmd.append("--save-ops")
    env = dict(os.environ)
    env.setdefault("PYTHONPATH", "src")
    return subprocess.run(cmd, env=env).returncode


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=list(configs.ARCH_IDS))
    ap.add_argument("--shape", choices=list(configs.SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--isolate", action="store_true",
                    help="run each cell in a subprocess (with --all)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--save-ops", action="store_true", help="write the per-op table")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--pad-heads", action="store_true",
                    help="physical TP head padding (perf variant)")
    ap.add_argument("--cache-dtype", default=None, choices=["bfloat16", "float8_e4m3fn"])
    ap.add_argument("--layout", default=None, choices=["tp", "dp256"])
    ap.add_argument("--impl", default=None, choices=["auto", "torch"])
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    options = {}
    if args.pad_heads:
        options["pad_heads"] = True
    for key in ("cache_dtype", "layout", "impl"):
        if getattr(args, key):
            options[key] = getattr(args, key)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    if args.all:
        t0 = time.time()
        failures = []
        for arch, shape_name, ok, _ in configs.all_cells(include_skipped=True):
            for multi_pod in meshes:
                mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
                path = cell_path(args.out, mesh_name, arch, shape_name)
                if args.skip_existing and os.path.exists(path):
                    print(f"[dryrun] exists, skipping {arch} x {shape_name} ({mesh_name})")
                    continue
                if args.isolate and ok:
                    rc = _run_isolated(arch, shape_name, "multi" if multi_pod else "single",
                                       args.out, args.save_ops)
                    if rc != 0:
                        failures.append((arch, shape_name, mesh_name, f"rc={rc}"))
                    continue
                try:
                    run_cell(arch, shape_name, multi_pod=multi_pod, out_dir=args.out,
                             save_ops=args.save_ops)
                except Exception as e:  # record failures, keep going
                    traceback.print_exc()
                    failures.append((arch, shape_name, mesh_name, repr(e)))
        print(f"\n[dryrun] {time.time() - t0:.1f} s")
        if failures:
            print("[dryrun] FAILURES:")
            for f in failures:
                print("  ", f)
            sys.exit(1)
        print("[dryrun] all cells passed")
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all, are required")
    for multi_pod in meshes:
        run_cell(args.arch, args.shape, multi_pod=multi_pod, out_dir=args.out,
                 save_ops=args.save_ops, options=options or None, tag=args.tag)


if __name__ == "__main__":
    main()

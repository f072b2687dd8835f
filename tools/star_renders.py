#!/usr/bin/env python
"""Render the five ★ baseline configs at FULL reference parameters
(BASELINE.md workload table; the preview gallery covers breadth, this
covers the headline configs at full scale):

  cornell      512x512, 500 spp, per-10-iteration variance (cornell.rs:87-106)
  photon_map   512x512, 10 spp, 10M photons (photon_map.rs:89-95)
  dragon       800x600 (dragon.rs:69-73; procedural stand-in asset)
  sphere       960x540, 100 spp (sphere.rs)
  lampshade    128x128, 10 spp, 1M photons (volumetric_photonphoton_lampshade)

Each runs in its own subprocess, one at a time (one JAX process reserves
most of the accelerator's memory; one hang must not sink the rest)
WITHOUT RPT_TPU_PREVIEW. Results land in gallery/star/<name>/
and gallery/star_results.json; tools/gallery.py's write_index renders them
as a second README table. Usage:

    python tools/star_renders.py [--only name,...] [--timeout 5400]
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
OUT = os.path.join(REPO, "gallery")
STAR = os.path.join(OUT, "star")

CONFIGS = [
    ("cornell", "cornell.py", "512x512 500spp"),
    ("sphere", "sphere.py", "960x540 100spp"),
    ("dragon", "dragon.py", "800x600"),
    ("lampshade", "volumetric_photonphoton_lampshade.py",
     "128x128 10spp 1M photons"),
    ("photon_map", "photon_map.py", "512x512 10spp 10M photons"),
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", type=str, default="")
    ap.add_argument("--timeout", type=int, default=5400)
    args = ap.parse_args()

    configs = CONFIGS
    if args.only:
        only = set(args.only.split(","))
        configs = [c for c in configs if c[0] in only]

    os.makedirs(STAR, exist_ok=True)
    path = os.path.join(OUT, "star_results.json")
    old = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                for r in json.load(f):
                    old[r["name"]] = r
        except (json.JSONDecodeError, KeyError):
            pass

    for name, script, params in configs:
        workdir = os.path.join(STAR, name)
        shutil.rmtree(workdir, ignore_errors=True)
        os.makedirs(workdir)
        env = dict(
            os.environ,
            # PREPEND the repo; never replace PYTHONPATH wholesale
            PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
        )
        env.pop("RPT_TPU_PREVIEW", None)
        env["RPT_TPU_FRAMES"] = "2"  # video drivers: bound frame count
        t0 = time.time()
        try:
            proc = subprocess.run(
                [sys.executable, os.path.join(EXAMPLES, script)],
                cwd=workdir, env=env, timeout=args.timeout,
                capture_output=True, text=True,
            )
            rc = proc.returncode
            tail = (proc.stderr or "")[-3000:]
        except subprocess.TimeoutExpired:
            rc, tail = -1, "TIMEOUT"
        wall = time.time() - t0
        pngs = sorted(
            os.path.relpath(os.path.join(dp, f), workdir)
            for dp, _, files in os.walk(workdir)
            for f in files
            if f.endswith(".png")
        )
        ok = rc == 0 and bool(pngs)
        old[name] = dict(name=name, params=params, ok=ok, rc=rc, images=pngs)
        print(f"star/{name:12s} {'OK ' if ok else 'FAIL'} {wall:8.1f}s "
              f"{len(pngs)} image(s)", flush=True)
        if not ok:
            with open(os.path.join(workdir, "stderr.txt"), "w") as f:
                f.write(tail)
        # persist after EVERY config (a later timeout must not lose rows)
        with open(path, "w") as f:
            json.dump([old[k] for k, _s, _p in CONFIGS if k in old], f,
                      indent=1)

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from gallery import write_index

    write_index([])  # regenerate README (merges star_results.json)
    n_ok = sum(1 for r in old.values() if r["ok"])
    print(f"\n{n_ok}/{len(old)} star configs rendered -> {STAR}")


if __name__ == "__main__":
    main()

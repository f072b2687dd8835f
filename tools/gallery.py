#!/usr/bin/env python
"""Render every example driver into ``gallery/`` with an index — the
per-example render evidence for PARITY.md.

Each example runs in its own subprocess, one at a time (one JAX process
reserves most of the accelerator's memory; a crash or hang in one driver
must not sink the rest) under RPT_TPU_PREVIEW so the whole suite finishes
in a bounded time. Usage:

    python tools/gallery.py [--scale 4] [--samples 16] [--only name,...]
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


def example_names():
    return sorted(
        f[:-3]
        for f in os.listdir(EXAMPLES)
        if f.endswith(".py") and not f.startswith("_")
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=4,
                    help="RPT_TPU_PREVIEW resolution divisor")
    ap.add_argument("--samples", type=int, default=16)
    ap.add_argument("--photons", type=int, default=200_000)
    ap.add_argument("--timeout", type=int, default=2400)
    ap.add_argument("--only", type=str, default="")
    args = ap.parse_args()

    names = example_names()
    if args.only:
        only = set(args.only.split(","))
        names = [n for n in names if n in only]

    os.makedirs(OUT, exist_ok=True)
    results = []
    for name in names:
        workdir = os.path.join(OUT, name)
        shutil.rmtree(workdir, ignore_errors=True)
        os.makedirs(workdir)
        env = dict(
            os.environ,
            # PREPEND the repo (examples import rpt_tpu); never replace
            # PYTHONPATH wholesale
            PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
            RPT_TPU_PREVIEW=str(args.scale),
            RPT_TPU_PREVIEW_SAMPLES=str(args.samples),
            RPT_TPU_PREVIEW_PHOTONS=str(args.photons),
            RPT_TPU_FRAMES="2",
        )
        t0 = time.time()
        try:
            proc = subprocess.run(
                [sys.executable, os.path.join(EXAMPLES, f"{name}.py")],
                cwd=workdir, env=env, timeout=args.timeout,
                capture_output=True, text=True,
            )
            rc = proc.returncode
            tail = (proc.stderr or "")[-2000:]
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
        results.append(dict(name=name, ok=ok, rc=rc, images=pngs))
        print(f"{name:36s} {'OK ' if ok else 'FAIL'} {wall:7.1f}s "
              f"{len(pngs)} image(s)", flush=True)
        if not ok:
            with open(os.path.join(workdir, "stderr.txt"), "w") as f:
                f.write(tail)

    merged = write_index(results, scale=args.scale, samples=args.samples,
                         photons=args.photons)
    n_ok = sum(r["ok"] for r in results)
    print(f"\n{n_ok}/{len(results)} examples rendered "
          f"({len(merged)} total in index) -> {OUT}")


def write_index(new_results, scale=4, samples=16, photons=200_000):
    """MERGE ``new_results`` into gallery/results.json (keyed by example
    name — a partial --only re-render must never drop the other rows; the
    round-3 overwrite shrank the 29-row index to 2) and regenerate
    README.md from the merged set."""
    path = os.path.join(OUT, "results.json")
    old = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                for r in json.load(f).get("results", []):
                    old[r["name"]] = r
        except (json.JSONDecodeError, KeyError):
            pass
    for r in new_results:
        old[r["name"]] = r
    merged = [old[k] for k in sorted(old)]
    with open(path, "w") as f:
        json.dump(dict(scale=scale, samples=samples, results=merged),
                  f, indent=1)

    with open(os.path.join(OUT, "README.md"), "w") as f:
        f.write("# Example gallery\n\n")
        f.write(
            "Every image below was rendered by the corresponding driver\n"
            "under `examples/` (preview scale "
            f"1/{scale}, {samples} spp cap, photon cap {photons}; the\n"
            "drivers' full-resolution parameters match the reference's).\n"
            "Photon drivers that the reference ships with `watts=100`\n"
            "render near-black by design — see PARITY.md.\n\n"
        )
        f.write("| example | status | images |\n|---|---|---|\n")
        for r in merged:
            imgs = " ".join(
                f"![{i}]({r['name']}/{i})" for i in r["images"][:3]
            )
            f.write(f"| {r['name']} | {'✅' if r['ok'] else '❌'} | {imgs} |\n")

        star_path = os.path.join(OUT, "star_results.json")
        if os.path.exists(star_path):
            try:
                with open(star_path) as sf:
                    stars = json.load(sf)
            except json.JSONDecodeError:
                stars = []
            if stars:
                f.write(
                    "\n## ★ baseline configs at FULL reference parameters\n\n"
                    "Rendered by `tools/star_renders.py` (no preview env — "
                    "the exact\nreference workload definitions).\n\n"
                )
                f.write("| config | params | status | images |\n"
                        "|---|---|---|---|\n")
                for r in stars:
                    imgs = " ".join(
                        f"![{i}](star/{r['name']}/{i})"
                        for i in r["images"][:2]
                    )
                    f.write(
                        f"| {r['name']} | {r['params']} | "
                        f"{'✅' if r['ok'] else '❌'} | {imgs} |\n"
                    )
    return merged


if __name__ == "__main__":
    main()

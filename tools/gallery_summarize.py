#!/usr/bin/env python
"""(Re)build gallery/results.json + gallery/README.md from whatever is
on disk — usable mid-run or after a truncated tools/gallery.py pass."""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "gallery")


def main():
    results = []
    for name in sorted(os.listdir(OUT)):
        workdir = os.path.join(OUT, name)
        if not os.path.isdir(workdir):
            continue
        pngs = sorted(
            os.path.relpath(os.path.join(dp, f), workdir)
            for dp, _, files in os.walk(workdir)
            for f in files
            if f.endswith(".png")
        )
        ok = bool(pngs)
        results.append(dict(name=name, ok=ok, images=pngs))

    with open(os.path.join(OUT, "results.json"), "w") as f:
        json.dump(dict(results=results), f, indent=1)

    with open(os.path.join(OUT, "README.md"), "w") as f:
        f.write("# Example gallery\n\n")
        f.write(
            "Every image below was rendered by the corresponding driver\n"
            "under `examples/` (preview scale; the\n"
            "drivers' full-resolution parameters match the reference's).\n"
            "Photon drivers that the reference ships with `watts=100`\n"
            "render near-black by design — see PARITY.md.\n\n"
        )
        f.write("| example | status | images |\n|---|---|---|\n")
        for r in results:
            imgs = " ".join(
                f"![{os.path.basename(i)}]({r['name']}/{i})"
                for i in r["images"][:3]
            )
            f.write(
                f"| {r['name']} | {'✅' if r['ok'] else '❌'} | {imgs} |\n"
            )
    n_ok = sum(r["ok"] for r in results)
    print(f"{n_ok}/{len(results)} examples have images -> {OUT}/README.md")


if __name__ == "__main__":
    main()

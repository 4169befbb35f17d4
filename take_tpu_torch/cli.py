"""CLI: `python -m take_tpu_torch.cli scene.xml [-max_depth N] [-integrator I] [-o out] [-device cuda]`.

Mirrors the reference CLI (main.cpp:8-27 + render.cpp:14-22): positional
scene path, -max_depth (default 50), writes the film's output filename
(default image.exr) in the current directory. `-t` is accepted and ignored.
"""

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="take-tpu-torch")
    ap.add_argument("scene", help="Mitsuba-XML scene file")
    ap.add_argument("-max_depth", type=int, default=50)
    ap.add_argument("-t", type=int, default=0, help="ignored")
    ap.add_argument("-o", "--output", default=None, help="override output path")
    ap.add_argument("-spp", type=int, default=None, help="override sampler spp")
    ap.add_argument("-seed", type=int, default=0)
    ap.add_argument(
        "-rr_depth", type=int, default=-1,
        help="Russian roulette from this bounce (unbiased; -1 = off, the "
        "reference-parity default)",
    )
    ap.add_argument(
        "-integrator", default="mis",
        choices=["mis", "mis_scan", "mis_wavefront", "mis_replay", "one_sample_mis",
                 "one_sample_mis_power", "raw"],
        help="mis (= mis_scan) runs the scan loop, mis_wavefront the refill loop, mis_replay the early-exit "
        "loop of the path-replay gradient (the same image as mis)",
    )
    ap.add_argument("-device", default="cuda", help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)

    from take_tpu_torch.io.exr import write_exr
    from take_tpu_torch.io.pfm import write_pfm
    from take_tpu_torch.render import render_image
    from take_tpu_torch.scene.parse_xml import parse_scene_file
    from take_tpu_torch.scene.types import RenderOptions

    print(f"Parsing and constructing scene {args.scene}.")
    t0 = time.time()
    builder = parse_scene_file(args.scene, build=False)
    scene = builder.build(device=args.device)
    print(f"Scene parsing done. Took {time.time() - t0:.3f} seconds.")

    options = RenderOptions(
        spp=args.spp or builder.spp,
        max_depth=args.max_depth,
        integrator=args.integrator,
        seed=args.seed,
        rr_depth=args.rr_depth,
    )
    print("Rendering...")
    t0 = time.time()
    img = render_image(scene, options)
    print(f"Finish rendering. Took {time.time() - t0:.3f} seconds.")

    out = args.output or builder.output_filename
    if out.endswith(".pfm"):
        write_pfm(out, img)
    else:
        write_exr(out, img)
    print(f"Wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

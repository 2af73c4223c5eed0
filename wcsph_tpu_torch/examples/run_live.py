"""Live-view dam break: the reference's interactive GUI loop
(dfsph.py:595-624, ``while gui.running: step; gui.set_image; gui.show``)
on a headless GPU host: frames rasterize on the card
(render.render_points) and stream as PNG frames to a browser tab
(wcsph_tpu_torch/viewer.py).

Usage:
  python -m wcsph_tpu_torch.examples.run_live --solver dfsph --side 16 \
      --port 8089
  # then open the printed URL; the page's Stop button ends the run.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--solver", default="dfsph",
                    choices=["sesph", "pcisph", "iisph", "dfsph"])
    ap.add_argument("--side", type=int, default=16, help="fluid cube side")
    ap.add_argument("--radius", type=float, default=0.025)
    ap.add_argument("--port", type=int, default=8089)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--frames", type=int, default=0,
                    help="stop after N frames (0 = until Stop is clicked)")
    ap.add_argument("--steps-per-frame", type=int, default=2)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from wcsph_tpu_torch import dam_break, render
    from wcsph_tpu_torch.simulation import Simulation, default_config
    from wcsph_tpu_torch.viewer import run_live

    r = args.radius
    sc = dam_break(particle_radius=r, fluid_dims=(args.side,) * 3,
                   box_extent=args.side * 2 * r * 1.35)
    lo, hi = sc.domain(pad=6 * r)
    cfg = default_config(args.solver, particle_radius=r, domain_min=lo,
                         domain_max=hi)
    sim = Simulation(sc, cfg, solver=args.solver, device=args.device)
    canvas = render.Canvas(args.res, args.res)
    mid = [(float(a) + float(b)) / 2 for a, b in zip(lo, hi)]
    canvas.camera.yaw_cam(*mid)

    t0 = time.time()

    def telemetry(s, _img):
        canvas.camera.yaw_cam(*mid)         # reference's slow orbit
        tele = s.telemetry()
        print(f"t={tele['time']:.3f}s dt={tele['dt']:.1e} "
              f"iters={tele['pressure_iters']} "
              f"wall={time.time() - t0:.1f}s", flush=True)

    frames = run_live(sim, canvas, host=args.host, port=args.port,
                      max_frames=args.frames or None,
                      render_every=args.steps_per_frame,
                      frame_cb=telemetry)
    print(f"done: {frames} frames")


if __name__ == "__main__":
    main()

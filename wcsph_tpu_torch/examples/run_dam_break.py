"""Dam-break driver: the reference's `ti dfsph.py` / `ti sesph.py` frame
loops (dfsph.py:595-647) as a headless CLI, on the card.

Usage:
  python -m wcsph_tpu_torch.examples.run_dam_break --solver dfsph \
      --frames 200 --render --surface --out out/

Renders fps-gated PNGs, exports fps-gated surface meshes, prints the same
per-frame telemetry the reference prints (time, dt, solver iterations).
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--solver", default="dfsph",
                    choices=["sesph", "pcisph", "iisph", "dfsph"])
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--side", type=int, default=20, help="fluid cube side")
    ap.add_argument("--radius", type=float, default=0.025)
    ap.add_argument("--boundary-obj", default=None,
                    help="OBJ point cloud for the boundary (else box shell)")
    ap.add_argument("--render", action="store_true")
    ap.add_argument("--surface", action="store_true")
    ap.add_argument("--anisotropic", action="store_true")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--out", default="out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from wcsph_tpu_torch import scene
    from wcsph_tpu_torch.render import Canvas
    from wcsph_tpu_torch.simulation import Simulation, default_config
    from wcsph_tpu_torch.surface.reconstruction import SurfaceExporter
    from wcsph_tpu_torch.utils import checkpoint

    r = args.radius
    b = scene.SceneBuilder()
    spacing = 2 * r
    n = args.side
    b.add_liquid_block((n, n, n), spacing,
                       (-0.5 * n * spacing + 0.5 * spacing, 0.2,
                        -0.5 * n * spacing + 0.5 * spacing))
    if args.boundary_obj:
        b.add_obj(args.boundary_obj)
    else:
        # floor at y=0 (the fluid block starts at y=0.2 like dfsph.py:70-73)
        extent = max(2.0, n * spacing * 1.6)
        b.add_box_shell(extent, spacing, center=(0.0, 0.5 * extent, 0.0))
    sc = b.build()
    lo, hi = sc.domain(pad=6 * r)
    cfg = default_config(args.solver, particle_radius=r,
                         domain_min=lo, domain_max=hi)
    sim = Simulation(sc, cfg, solver=args.solver, device=args.device)
    if args.resume:
        sim.state = checkpoint.load(args.resume, device=args.device)

    canvas = Canvas(512, 512) if args.render else None
    exporter = (SurfaceExporter(cfg, args.out, anisotropic=args.anisotropic)
                if args.surface else None)

    t0 = time.time()
    for frame in range(args.frames):
        sim.step()
        tel = sim.telemetry()
        print(f"time:{tel['time']:.3f} step:{tel['dt']:.4f} "
              f"viscosity:{tel['viscosity_iters']} "
              f"divergence:{tel['divergence_iters']} "
              f"pressure:{tel['pressure_iters']} "
              f"err:{tel['density_error']:.2e}")
        if canvas is not None:
            canvas.camera.static_cam(0.0, 0.5, 0.0)
            img = canvas.render(sim.state.pos, sim.state.n_liquid)
            canvas.export_png(img, tel["time"], prefix=f"{args.out}/frame_")
        if exporter is not None:
            exporter.maybe_export(sim.state)
        if args.checkpoint_every and (frame + 1) % args.checkpoint_every == 0:
            checkpoint.save(f"{args.out}/ck_{frame + 1}.npz", sim.state)
        sim.check_health()    # NaN watchdog (dfsph.py:645-647)
    wall = time.time() - t0
    print(f"{args.frames} frames in {wall:.1f}s "
          f"({sim.state.n_liquid * args.frames / wall:.3e} particle-steps/s)")


if __name__ == "__main__":
    main()

"""Non-box scene end-to-end: procedural mesh -> Poisson-disk boundary shell
-> DFSPH with surface tension -> anisotropic marching-cubes export, on the
card.

The pipeline of the reference's mesh-boundary configs (dfsph.py:80 /
iisph.py:110 load pre-sampled `model/*_boundry.obj` shells produced by
boundry.py).  The boundary mesh is generated procedurally
(utils/meshgen.py) and sampled by wcsph_tpu_torch.sampling.

  python -m wcsph_tpu_torch.examples.run_mesh_scene --frames 100 --shape sphere
"""

import argparse
import os
import time


def build_scene(shape: str, radius: float, device="cuda"):
    from wcsph_tpu_torch.sampling import poisson_disk_sample
    from wcsph_tpu_torch.scene import SceneBuilder
    from wcsph_tpu_torch.utils import meshgen

    spacing = 2.0 * radius
    if shape == "sphere":
        # hollow sphere bowl, fluid block dropped inside the upper half
        verts, faces = meshgen.icosphere(subdivisions=4, radius=0.5)
        fluid_dims = (10, 10, 10)
        fluid_origin = (-5 * spacing + 0.5 * spacing, -0.15,
                        -5 * spacing + 0.5 * spacing)
    elif shape == "tank":
        verts, faces = meshgen.open_tank(size=(1.2, 0.8, 1.2))
        fluid_dims = (12, 12, 12)
        fluid_origin = (-0.55, -0.35, -0.55)
    else:
        raise SystemExit(f"unknown shape {shape!r}")

    t0 = time.time()
    shell = poisson_disk_sample(verts, faces, radius=radius, device=device)
    print(f"[scene] sampled {shell.shape[0]} boundary particles "
          f"from {faces.shape[0]} faces in {time.time() - t0:.1f}s")

    b = SceneBuilder()
    b.add_liquid_block(fluid_dims, spacing, fluid_origin)
    for p in shell:
        b.add_solid_point(p)
    return b.build()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="sphere", choices=["sphere", "tank"])
    ap.add_argument("--radius", type=float, default=0.025)
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--steps-per-frame", type=int, default=5)
    ap.add_argument("--tension", type=float, default=0.5)
    ap.add_argument("--export-surface", action="store_true")
    ap.add_argument("--out", default="out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from wcsph_tpu_torch.simulation import Simulation, default_config
    from wcsph_tpu_torch.surface.reconstruction import reconstruct
    from wcsph_tpu_torch.utils import objio

    sc = build_scene(args.shape, args.radius, args.device)
    lo, hi = sc.domain(pad=6 * args.radius)
    cfg = default_config("dfsph", particle_radius=args.radius,
                         domain_min=lo, domain_max=hi,
                         tension_coff=args.tension)
    sim = Simulation(sc, cfg, solver="dfsph", device=args.device)
    print(f"[scene] n_liquid={sim.state.n_liquid} n_solid={sc.n_solid} "
          f"grid={cfg.grid_res}")

    for frame in range(args.frames):
        t0 = time.time()
        sim.run(args.steps_per_frame)
        sim.check_health()
        tel = sim.telemetry()
        print(f"[frame {frame:4d}] t={tel['time']:.4f} dt={tel['dt']:.2e} "
              f"iters(p/d/v)={tel['pressure_iters']}/"
              f"{tel['divergence_iters']}/{tel['viscosity_iters']} "
              f"err={tel['density_error']:.2e} "
              f"({time.time() - t0:.2f}s)")
        if args.export_surface and frame % 10 == 0:
            verts, tris = reconstruct(sim.state, cfg, anisotropic=True)
            path = f"{args.out}/mesh_scene_{frame:04d}.obj"
            os.makedirs(args.out, exist_ok=True)
            objio.save_obj(path, verts, tris)
            print(f"  surface: {verts.shape[0]} verts -> {path}")

    print("[done] final telemetry:", sim.telemetry())


if __name__ == "__main__":
    main()

"""Boundary shell generation (reference boundry.py CLI):
  python -m wcsph_tpu_torch.examples.sample_boundary model.obj --radius 0.025
writes model_boundry.obj with Poisson-disk surface samples, sampled on the
card.
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mesh")
    ap.add_argument("--radius", type=float, default=0.025)
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from wcsph_tpu_torch.sampling import sample_obj

    out = args.out or args.mesh.rsplit(".", 1)[0] + "_boundry.obj"
    pts = sample_obj(args.mesh, out, radius=args.radius, trials=args.trials,
                     device=args.device)
    print(f"wrote {pts.shape[0]} boundary samples to {out}")


if __name__ == "__main__":
    main()

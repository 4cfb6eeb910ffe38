"""Drive openobj_torch through its public package boundary (the port of
examples/synthetic_convergence.py): fit a 2-object stacked field to an
analytic scene (sphere at origin r=0.5, second sphere at x=2 r=0.3) from a
ring of cameras, then check that held-out rendered depth and colour
converge and the loss drops.

The field goes through ``ops.fused_field``: the CUDA kernels on a GPU, their
plain version on the CPU. The default device is the card; without one the
script stops and names the device (``--device cpu`` runs it on the CPU).

Run:  python examples/torch_synthetic_convergence.py [--device cpu|cuda]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from openobj_torch.core import optim, trainer  # noqa: E402
from openobj_torch.models import object_field  # noqa: E402
from openobj_torch.ops import fused_field, losses, rendering, sampling  # noqa: E402

O, R, P = 2, 256, 10
CENTERS = np.array([[0., 0., 0.], [2., 0., 0.]], np.float32)
RADII = np.array([0.5, 0.3], np.float32)
GT_COLOR = np.array([[0.8, 0.2, 0.1], [0.1, 0.6, 0.9]], np.float32)


def make_rays(gen, o, device):
    """Cameras on a ring of radius 2 around object o, aimed at points inside
    its sphere; analytic ray-sphere depth (0 where the ray misses)."""
    c = torch.as_tensor(CENTERS[o], device=device)
    ang = torch.rand((R,), generator=gen, device=device) * 2 * np.pi
    cam = torch.stack([torch.cos(ang), torch.sin(ang), torch.zeros_like(ang)], -1) * 2.0 + c
    tgt = c + torch.randn((R, 3), generator=gen, device=device) * float(RADII[o]) * 0.3
    d = tgt - cam
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    oc = cam - c
    b = torch.sum(oc * d, -1)
    cc = torch.sum(oc * oc, -1) - float(RADII[o]) ** 2
    disc = b * b - cc
    hit = disc > 0
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    depth = torch.where(hit, t, torch.zeros_like(t))
    return cam, d, depth, hit


def run(device="cuda", n_steps=300, seed=1):
    """Train and evaluate; returns {"losses", "depth_mae", "color_mae"}.
    Raises when ``device`` is a card and none is present."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = object_field.init_stacked_fields(gen, O, hidden=32, clip_size=8,
                                              scale=2.0, device=device)
    ostate = optim.init_adamw_state(params, n_slots=O)
    active = torch.tensor([True, True], device=device)
    gt_c = torch.as_tensor(GT_COLOR, device=device)[:, None, :].expand(O, R, 3)
    centers = torch.as_tensor(CENTERS, device=device)

    ls = []
    for i in range(n_steps):
        rays = [make_rays(gen, o, device) for o in range(O)]
        cam = torch.stack([r[0] for r in rays])
        d = torch.stack([r[1] for r in rays])
        depth = torch.stack([r[2] for r in rays])
        state = torch.stack([torch.where(r[3], 1, 0) for r in rays])
        z = sampling.sample_z_values(
            gen, depth, state, 0.0, 1, 9, 0.1, 0.05,
            max_bound=torch.amax(depth, dim=1, keepdim=True))
        pts = sampling.rays_to_points(cam, d, z, obj_center=centers[:, None, None, :])
        p, wrt = trainer.differentiable(params)
        a, c, _ = fused_field.field_apply_stacked_fused(p, pts, do_clip=False)
        loss, _ = losses.step_batch_loss(a[..., 0], c, depth, gt_c, state, z, active=active)
        grads = torch.autograd.grad(loss, [x for _, x in wrt], allow_unused=True)
        params, ostate = optim.adamw_update(
            params, optim.unflatten(zip([q for q, _ in wrt], grads)), ostate,
            lr=1e-3, weight_decay=0.013, active=active)
        if i % 50 == 0:
            ls.append(float(loss.detach()))

    # held-out eval on object 0
    egen = torch.Generator(device=device)
    egen.manual_seed(99)
    cam, d, dep_gt, hit = make_rays(egen, 0, device)
    z = torch.linspace(0.8, 2.5, 64, device=device).expand(R, 64)
    pts = sampling.rays_to_points(cam, d, z, obj_center=centers[0])
    with torch.no_grad():
        a, c, _ = fused_field.field_apply_fused(
            object_field.slice_slot(params, 0), pts, do_clip=False)
        w = rendering.occupancy_to_termination(rendering.occupancy_activation(a[..., 0]))
        rd = rendering.render(w, z)
        rc = rendering.render(w[..., None], c, axis=-2)
    err = (rd - dep_gt).abs()[hit].mean().item()
    cerr = (rc - torch.as_tensor(GT_COLOR[0], device=device)).abs().mean().item()
    return {"losses": ls, "depth_mae": err, "color_mae": cerr}


def check(res: dict) -> None:
    """The asserts of examples/synthetic_convergence.py:77-79."""
    ls = res["losses"]
    if not ls[0] > ls[-1] * 2:
        raise AssertionError(f"loss did not drop: {ls}")
    if not res["depth_mae"] < 0.15:
        raise AssertionError(f"depth did not converge: MAE {res['depth_mae']}")
    if not res["color_mae"] < 0.1:
        raise AssertionError(f"color did not converge: MAE {res['color_mae']}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.device)
    print("loss trajectory:", [round(x, 3) for x in out["losses"]])
    print(f"depth MAE on held-out rays (obj0): {out['depth_mae']:.4f} m")
    print(f"color MAE: {out['color_mae']:.4f}")
    check(out)
    print("CONVERGED OK")
    return out


if __name__ == "__main__":
    main()

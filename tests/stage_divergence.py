"""Where one odometry step of the port and of the reference part ways,
stage by stage, from a shared carry (LiDAR-only, the shapes of
``tiny_test_config()``, JAX and the port both on the CPU).

    JAX_PLATFORMS=cpu python tests/stage_divergence.py --seed 100 --frame 1

The JAX run enters ``--frame`` through its jitted step; the port's carry
is that carry (``carry_from_jax_numpy``).  Printed: the pose after the
whole step (both, and ground truth); the range image, curvature and
feature picks; the candidate caches; the first linearization at the
predicted pose on identical inputs (the reference's features and
candidates); the scan-to-scan solve per outer iteration, with the LM
accept counts, on those identical inputs; and the same first
linearization through JAX eagerly and jitted, which shows how far the
reference's own two evaluations of one function differ.  A tool, not a
test (pytest does not collect it); it imports both packages, as the
parity tests do.
"""
import argparse
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

from velo_tpu import config as jconfig  # noqa: E402
from velo_tpu.geom import se3 as jse3  # noqa: E402
from velo_tpu.io import fixtures  # noqa: E402
from velo_tpu.lidar import rangeimage as jri  # noqa: E402
from velo_tpu.pipeline import odometry as jodo  # noqa: E402
from velo_tpu.solve import icp as jicp  # noqa: E402
from velo_tpu_torch import config as tconfig  # noqa: E402
from velo_tpu_torch.geom import se3 as tse3  # noqa: E402
from velo_tpu_torch.lidar import rangeimage as tri  # noqa: E402
from velo_tpu_torch.pipeline import odometry as todo  # noqa: E402
from velo_tpu_torch.solve import icp as ticp  # noqa: E402
from test_torch_odometry import _pose_diff  # noqa: E402


def _t(x):
    return torch.tensor(np.asarray(x))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--frame", type=int, default=1)
    args = ap.parse_args()
    torch.set_num_threads(1)
    jc = dataclasses.replace(jconfig.tiny_test_config(), use_vision=False,
                             use_map=True, prebin_host=True)
    tc = dataclasses.replace(tconfig.tiny_test_config(), use_vision=False,
                             use_map=True, prebin_host=True)
    fx = fixtures.make_fixture(n_frames=args.frame + 1, n_rings=32,
                               n_azimuth=1024, with_images=False,
                               seed=args.seed)
    frames = [jri.bin_scan_host(s, jc.lidar) for s in fx.scans]
    gt = np.linalg.inv(fx.gt_poses_velo[0]) @ fx.gt_poses_velo
    carry = jodo.init_carry(jc)
    for g, v in frames[:args.frame]:
        carry, _ = jodo.jit_step(carry, jnp.asarray(g), jnp.asarray(v), jc)
    shared = jax.tree.map(np.asarray, carry)
    g, v = frames[args.frame]
    _, jout = jodo.jit_step(carry, jnp.asarray(g), jnp.asarray(v), jc)
    tcar = todo.carry_from_jax_numpy(shared, "cpu")
    _, tout = todo.step(tcar, torch.tensor(g), torch.tensor(v), tc)
    jT, tT = np.asarray(jout.T_w), tout.T_w.numpy()
    dt, dr = _pose_diff(tT, jT)
    print(f"seed {args.seed}, frame {args.frame}: x port {tT[0, 3]:.4f}, JAX "
          f"{jT[0, 3]:.4f}, ground truth {gt[args.frame][0, 3]:.4f}; port vs "
          f"JAX {dt:.4f} m, {dr:.4f} deg")

    # Front end.
    ri_j = jri.range_image_from_grid(jnp.asarray(g), jnp.asarray(v),
                                     carry.delta, jc.lidar, enabled=True)
    ri_t = tri.range_image_from_grid(torch.tensor(g), torch.tensor(v),
                                     tcar.delta, tc.lidar, enabled=True)
    print("range image equal:", all(np.array_equal(
        np.asarray(getattr(ri_j, f)), getattr(ri_t, f).numpy())
        for f in ("xyz", "rng", "valid")))
    jf, _ = jodo._extract_features_from_ri(ri_j, jc)
    tf, _ = todo._extract_features_from_ri(ri_t, tc)
    for f in jf._fields:
        a, b = np.asarray(getattr(jf, f)), getattr(tf, f).numpy()
        rows = np.where((a != b).reshape(len(a), -1).any(-1))[0]
        print(f"features {f}: {len(rows)} slots differ {rows[:8].tolist()}")

    # Candidates, and the solve on the reference's own inputs.
    sc_j, sc_t = jc.solver, tc.solver
    jet = jicp.make_targets(carry.prev_edges, carry.prev_edge_mask,
                            payload=carry.prev_edge_ring[:, None])
    jpt = jicp.make_targets(carry.prev_planars, carry.prev_planar_mask)
    tet = ticp.make_targets(tcar.prev_edges, tcar.prev_edge_mask,
                            payload=tcar.prev_edge_ring[:, None])
    tpt = ticp.make_targets(tcar.prev_planars, tcar.prev_planar_mask)
    Tp_j, Tp_t = jse3.exp(carry.delta), tse3.exp(tcar.delta)
    jcands = [jicp.build_candidates(t, q, m, Tp_j, sc_j) for t, q, m in (
        (jet, jf.edges, jf.edge_mask), (jpt, jf.planars, jf.planar_mask))]
    tcands = [ticp.build_candidates(t, q, m, Tp_t, sc_t) for t, q, m in (
        (tet, tf.edges, tf.edge_mask), (tpt, tf.planars, tf.planar_mask))]
    for name, a, b in zip(("edge", "planar"), jcands, tcands):
        same = (np.asarray(a.pts) == b.pts.numpy()).all(-1)
        print(f"{name} candidates: identical slots {same.mean():.4f}, ok "
              f"equal {np.array_equal(np.asarray(a.ok), b.ok.numpy())}")
    tf = tf._replace(**{f: _t(getattr(jf, f)) for f in jf._fields})
    tcands = [ticp.CandCache(pts=_t(c.pts), payload=_t(c.payload),
                             ok=_t(c.ok)) for c in jcands]
    prior_j = (carry.frame_idx >= 2).astype(jnp.float32)
    prior_t = (tcar.frame_idx >= 2).to(torch.float32)

    def first_linearization(mod, f, cands, sc, Tp, prior, eye):
        eq = mod._cand_query(cands[0], sc)
        pq = mod._cand_query(cands[1], sc)
        a, b, e_ok = mod._edge_lines_2pt(eq, f.edges, f.edge_mask)
        n, d, p_ok, p_q = mod._planar_planes_fit(pq, f.planars,
                                                 f.planar_mask, sc.map_knn)
        stage = mod._make_stage(sc, Tp, prior, mod.make_lidar_system(
            f.edges, f.edge_mask, a, b, e_ok, f.planars, f.planar_mask, n,
            d, p_ok, sc, planar_q=p_q))
        return stage(eye, None)[:3] + (p_ok,)

    def jax_lin(f):
        return first_linearization(jicp, f, jcands, sc_j, Tp_j, prior_j,
                                   jnp.eye(4, dtype=jnp.float32))

    def host(lin):
        return tuple(np.asarray(x) for x in lin)

    jlin = host(jax_lin(jf))
    tlin = host(first_linearization(ticp, tf, tcands, sc_t, Tp_t, prior_t,
                                    torch.eye(4)))

    def compare(what, a, b):
        flips = int((a[3] != b[3]).sum())
        h_rel = np.abs(a[0] - b[0]).max() / np.abs(a[0]).max()
        g_rel = np.abs(a[1] - b[1]).max() / np.abs(a[1]).max()
        print(f"{what}: H rel {h_rel:.2e}, g rel {g_rel:.2e}, cost "
              f"{float(a[2]):.7g} / {float(b[2]):.7g}, plane gates flipped "
              f"{flips}")

    compare("first linearization, port vs JAX eager", tlin, jlin)
    compare("first linearization, JAX jit vs JAX eager",
            host(jax.jit(jax_lin)(jf)), jlin)

    def solve(mod, f, tg, cands, sc, Tp, prior, outer):
        return mod.solve_scan_to_scan(
            f.edges, f.edge_mask, f.planars, f.planar_mask, tg[0], tg[1], Tp,
            sc, iters=outer, edge_cands=cands[0], planar_cands=cands[1],
            prior_T=Tp, prior_scale=prior)

    for outer in range(1, sc_t.icp_iters_odom + 1):
        Tj, dj = solve(jicp, jf, (jet, jpt), jcands, sc_j, Tp_j, prior_j,
                       outer)
        with jax.disable_jit():  # the reference evaluated op by op
            Te, de = solve(jicp, jf, (jet, jpt), jcands, sc_j, Tp_j,
                           prior_j, outer)
        Tt, dt_ = solve(ticp, tf, (tet, tpt), tcands, sc_t, Tp_t, prior_t,
                        outer)
        d = _pose_diff(Tt.numpy(), np.asarray(Tj))
        e = _pose_diff(Tt.numpy(), np.asarray(Te))
        print(f"scan-to-scan, {outer} outer iteration(s): LM accepts JAX "
              f"{int(dj.lm_accept)}, JAX eager {int(de.lm_accept)}, port "
              f"{int(dt_.lm_accept)}; planes {int(dj.n_planar)} / "
              f"{int(de.n_planar)} / {int(dt_.n_planar)}; x "
              f"{float(Tj[0, 3]):.4f} / {float(Te[0, 3]):.4f} / "
              f"{float(Tt[0, 3]):.4f}; port vs JAX {d[0]:.4f} m, "
              f"{d[1]:.4f} deg, vs JAX eager {e[0]:.4f} m, {e[1]:.4f} deg")

if __name__ == "__main__":
    main()

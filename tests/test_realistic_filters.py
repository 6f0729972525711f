"""Closing the borderline-accept quality loop: an earlier build measured
the engine accepting more borderline realistic seeds than the serial
oracle (median surface distance ~5x the mutual accepts') and DEFENDED
them as "seeds the post-filters exist to prune" — this test actually
runs the -f post-filter pipeline (mvs.cpp:279-525) over the realistic
seed clouds and checks the defense holds:

  (a) the engine-only borderline accepts are pruned at a materially higher
      rate than the mutually-accepted seeds;
  (b) the post-filter engine cloud's median surface distance closes to
      parity with the post-filter oracle cloud's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pais_mvs_tpu.config import MvsConfig
from pais_mvs_tpu.data.realistic import make_realistic_scene
from pais_mvs_tpu.engine.reconstructor import Reconstructor
from pais_mvs_tpu.models import patch as patch_mod
from pais_mvs_tpu.models.camera import build_scene
from pais_mvs_tpu.ops import lifecycle as lc
from pais_mvs_tpu.oracle import OraclePipeline


def test_borderline_engine_accepts_die_in_filters():
    rsc = make_realistic_scene(num_seeds=128, seed=0)
    rcfg = MvsConfig(patch_radius=6, max_lod=4, particle_num=8,
                     max_iteration=12, dist_weighting=2.0, cell_size=12,
                     min_cam_num=3, batch_size=128,
                     neighbor_radius_scalar=0.01)
    rscene = build_scene(rsc.params, rsc.images, rcfg)
    Br = (len(rsc.seed_centers) // 8) * 8

    # engine seed refine — the bench realistic gate's exact workload
    rpb = patch_mod.from_seeds(rsc.seed_centers[:Br],
                               rsc.seed_cam_masks[:Br],
                               rsc.seed_img_points[:Br])
    rpb = lc.prepare_seeds(rscene, rcfg, rpb)
    rres = lc.refine_batch(rscene, rcfg, rpb, jax.random.PRNGKey(3),
                           jnp.float32(0.01), True, 2)
    out = jax.device_get(rres.batch)
    ekeep = np.asarray(out.valid)

    # serial reference-semantics oracle on the IDENTICAL scene/config
    orc = OraclePipeline(rsc.params, rsc.images, rcfg, seed=0)
    orc.load_seeds(rsc.seed_centers[:Br], rsc.seed_cam_masks[:Br],
                   rsc.seed_img_points[:Br])
    pats0 = list(orc.patches)       # slot-ordered handles (drop flags
    orc.refine_seeds()              # survive the survivor re-numbering)
    okeep = np.asarray([not p.drop for p in pats0])

    engine_only = ekeep & ~okeep
    mutual = ekeep & okeep
    print(f"\naccepts: engine {ekeep.sum()}/{Br}, oracle {okeep.sum()}/{Br},"
          f" mutual {mutual.sum()}, engine-only {engine_only.sum()}")
    assert mutual.sum() >= 30, "comparison degenerate"
    assert engine_only.sum() >= 4, "no borderline accepts to test"

    d = np.full(Br, np.nan)
    d[ekeep] = rsc.surface_distance(out.center[ekeep])
    med_eo = float(np.median(d[engine_only]))
    med_mu = float(np.median(d[mutual]))
    print(f"pre-filter median dist: mutual {med_mu:.5f}, "
          f"engine-only {med_eo:.5f}")
    # the round-4 borderline claim: engine-only accepts are materially
    # worse than the mutual ones (4.4e-3 vs ~8e-4 measured)
    assert med_eo > 2.0 * med_mu, (med_eo, med_mu)

    # the post-filters are DENSITY/ratio passes (mvs.cpp:279-525) — on a
    # bare 65-seed cloud they prune nothing (measured: 0/65; seeds have no
    # cellmates to out-vote them). The reference runs -f on the EXPANDED
    # cloud, so the borderline-accept defense must be tested there: expand
    # from the accepted seeds, filter, then ask what happened to the
    # borderline seeds in the dense context.
    rec = Reconstructor(rsc.params, rsc.images, rcfg, verbose=False)
    ids = rec._append_to_arena(out, ekeep, is_seed=True)
    rec._update_neighbor_radius()
    rec.expand(max_rounds=60)
    n_dense = len(rec.arena.live_ids())
    rec.run_filters(0.25)
    slots = np.nonzero(ekeep)[0]          # arena ids 0..n-1 = these slots
    surv = np.zeros(Br, bool)
    live = rec.arena.live_ids()
    seed_live = live[live < len(slots)]
    surv[slots[np.asarray(seed_live, int)]] = True

    prune_eo = 1.0 - surv[engine_only].mean()
    prune_mu = 1.0 - surv[mutual].mean()
    print(f"dense cloud {n_dense} -> filtered "
          f"{len(rec.arena.live_ids())}; seed prune rate: engine-only "
          f"{prune_eo:.3f}, mutual {prune_mu:.3f}")

    # oracle arm: expand + its own serial -f filters, for the (b) gap
    orc.expand(max_patches=4000)
    n_orc_dense = len(orc.patches)
    orc.run_filters(0.25)
    opts = orc.cloud()
    print(f"oracle dense cloud {n_orc_dense} -> filtered {len(opts)}")
    med_o_f = float(np.median(rsc.surface_distance(opts))) if len(opts) \
        else np.inf
    epts = rec.live_centers()
    med_e_f = float(np.median(rsc.surface_distance(epts)))
    print(f"post-filter clouds: engine {len(epts)} median {med_e_f:.5f}; "
          f"oracle {len(opts)} median {med_o_f:.5f}")

    # (a) borderline accepts die at a materially higher rate (measured
    # round 5: 0.786 vs 0.373)
    assert prune_eo >= prune_mu + 0.25, (prune_eo, prune_mu)
    # (b) the post-filter median gap closes to parity (the PRE-filter gap
    # was ~1.7x, round 4; measured round 5: 8.0e-4 vs 8.3e-4). The
    # absolute-healthy fallback guards against the oracle's small filtered
    # cloud making its median a noisy denominator.
    assert med_e_f <= 1.35 * med_o_f or med_e_f < 1.2e-3, \
        (med_e_f, med_o_f)

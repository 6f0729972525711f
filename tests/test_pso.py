"""Batched GLN-PSO on synthetic fitness landscapes with known minima."""

import numpy as np
import jax
import jax.numpy as jnp

from pais_mvs_tpu.ops.pso import gln_pso


def test_quadratic_bowls_batched():
    """Each swarm minimizes a quadratic with a different optimum."""
    B, D = 16, 3
    rng = np.random.default_rng(0)
    opt = jnp.asarray(rng.uniform(-1, 1, size=(B, D)), dtype=jnp.float32)

    def fit(pos):
        return jnp.sum((pos - opt[:, None, :]) ** 2, axis=-1)

    lo = jnp.full((B, D), -2.0)
    hi = jnp.full((B, D), 2.0)
    res = gln_pso(fit, lo, hi, None, jax.random.PRNGKey(0),
                  particle_num=16, max_iteration=60)
    err = np.abs(np.asarray(res.gbest) - np.asarray(opt)).max()
    assert err < 0.05, err
    assert float(jnp.max(res.gbest_fit)) < 0.01


def test_seeded_incumbent_never_lost():
    """Seeding particle 0 with the exact optimum: gbest must stay there."""
    B, D = 4, 2
    opt = jnp.asarray([[0.3, -0.4]] * B, dtype=jnp.float32)

    def fit(pos):
        return jnp.sum((pos - opt[:, None, :]) ** 2, axis=-1)

    lo = jnp.full((B, D), -1.0)
    hi = jnp.full((B, D), 1.0)
    res = gln_pso(fit, lo, hi, opt, jax.random.PRNGKey(1),
                  particle_num=6, max_iteration=10)
    np.testing.assert_allclose(np.asarray(res.gbest), np.asarray(opt),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(res.gbest_fit), 0.0, atol=1e-9)


def test_early_convergence_freezes_iterations():
    """A converged swarm stops counting iterations (dispersion+velocity)."""
    B, D = 2, 2
    opt = jnp.zeros((B, D))

    def fit(pos):
        return jnp.sum((pos - opt[:, None, :]) ** 2, axis=-1)

    # swarm bounds so tight everything converges immediately
    lo = jnp.asarray([[-1e-4, -1e-4], [-2.0, -2.0]])
    hi = jnp.asarray([[1e-4, 1e-4], [2.0, 2.0]])
    res = gln_pso(fit, lo, hi, None, jax.random.PRNGKey(2),
                  particle_num=8, max_iteration=30)
    iters = np.asarray(res.iterations)
    assert iters[0] < iters[1]


def test_multimodal_gln_beats_bounds():
    """Rastrigin-like 1D landscape: the swarm should land in the global
    basin, not just anywhere in range."""
    B = 8

    def fit(pos):
        x = pos[..., 0]
        return (x - 0.5) ** 2 + 0.3 * jnp.sin(8 * x) ** 2

    lo = jnp.full((B, 1), -3.0)
    hi = jnp.full((B, 1), 3.0)
    res = gln_pso(fit, lo, hi, None, jax.random.PRNGKey(3),
                  particle_num=24, max_iteration=80)
    fits = np.asarray(res.gbest_fit)
    assert np.median(fits) < 0.05


def test_exit_chunk_bit_identical():
    """Chunked early-exit (exit_chunk > 0) must be BIT-identical to the
    fixed-length scan: frozen swarms never change state, so truncating
    all-frozen tail chunks cannot change any output. Covers chunk sizes
    that do and do not divide max_iteration, plus a fast-converging batch
    (tight bounds) where the exit actually fires early."""
    B, D = 12, 3
    rng = np.random.default_rng(4)
    opt = jnp.asarray(rng.uniform(-1, 1, size=(B, D)), dtype=jnp.float32)

    def fit(pos):
        return jnp.sum((pos - opt[:, None, :]) ** 2, axis=-1)

    for scale, key in ((2.0, 10), (1e-4, 11)):   # wide + instantly-frozen
        lo = jnp.full((B, D), -scale, jnp.float32)
        hi = jnp.full((B, D), scale, jnp.float32)
        base = gln_pso(fit, lo, hi, None, jax.random.PRNGKey(key),
                       particle_num=8, max_iteration=25)
        for chunk in (5, 7, 25, 40):             # divides / pads / >= max
            res = gln_pso(fit, lo, hi, None, jax.random.PRNGKey(key),
                          particle_num=8, max_iteration=25,
                          exit_chunk=chunk)
            np.testing.assert_array_equal(np.asarray(base.gbest),
                                          np.asarray(res.gbest))
            np.testing.assert_array_equal(np.asarray(base.gbest_fit),
                                          np.asarray(res.gbest_fit))
            np.testing.assert_array_equal(np.asarray(base.iterations),
                                          np.asarray(res.iterations))


def test_exit_chunk_under_jit_and_active0():
    """exit_chunk composes with jit and dead-swarm masking (active0)."""
    B, D = 8, 2
    opt = jnp.zeros((B, D), jnp.float32)

    def fit(pos):
        return jnp.sum((pos - opt[:, None, :]) ** 2, axis=-1)

    lo = jnp.full((B, D), -1.0, jnp.float32)
    hi = jnp.full((B, D), 1.0, jnp.float32)
    act0 = jnp.asarray([True, False] * (B // 2))

    def run(chunk):
        f = jax.jit(lambda: gln_pso(
            fit, lo, hi, None, jax.random.PRNGKey(5), particle_num=6,
            max_iteration=12, active0=act0, exit_chunk=chunk))
        return f()

    base, res = run(0), run(4)
    np.testing.assert_array_equal(np.asarray(base.gbest),
                                  np.asarray(res.gbest))
    assert not np.asarray(res.iterations)[1]     # dead swarm never stepped

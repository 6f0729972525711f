"""Seed-patch generation from images (reference C9: TMVS/mvs/featuremanager).

Batched JAX feature pipeline replacing the reference's OpenCV SIFT +
brute-force matcher (TMVS/mvs/featuremanager.cpp:5-116):

* ``detect``    — DoG scale-space keypoints as batched convolutions/pooling.
* ``describe``  — gradient-histogram descriptors on fixed sample grids.
* ``matching``  — all-pairs descriptor matching as one matmul per view
                  pair, cross-checked and epipolar-gated with analytic
                  fundamental matrices.
* ``seeding``   — n-view track union (host) + ray triangulation into seed
                  patches.
"""

from pais_mvs_tpu.features.seeding import generate_seed_patches  # noqa: F401

"""extractorb — a visual SLAM engine in JAX.

A from-scratch JAX/XLA re-design of the capability surface of
shanpenghui/ExtractORB (an ORB-SLAM3 learning fork):

- ``frontend``: ORB feature extraction (pyramid, FAST, orientation, rotated
  BRIEF, octree keypoint balancing) as batched, jit-compiled kernels, and
  descriptor matching as bit-plane matrix products.
- ``geometry``: camera models and two-view reconstruction (vmapped RANSAC).
- ``solver``: a Levenberg-Marquardt solver with Schur-complement landmark
  elimination that replaces the reference's g2o layer.
- ``imu``: on-manifold IMU preintegration as a ``lax.scan``.
- ``slam``: the map state (SoA pytrees) and the tracking / local-mapping /
  loop-closing pipeline as jit stages driven by a host scheduler.
- ``place``: vocabulary-tree place recognition as batched Hamming argmin.
- ``dist``: device-mesh sharding for distributed bundle adjustment.
- ``sim``: seeded synthetic scenes and solver problems with exact ground
  truth.

Design stance (NOT a port of the C++ reference): state is explicit pytrees of
fixed-shape padded+masked arrays, pipeline stages are pure jit functions, and
the host runs a thin scheduler replacing the reference's thread/mutex fabric
(reference: src/System.cc:180-205 spawns std::threads).
"""

__version__ = "0.1.0"

import jax as _jax

# With the default precision, XLA on a GPU may run float32 matrix products
# in TF32 (about three decimal digits).  The solvers' Jacobian products and
# normal equations are tuned and tested for float32 accuracy, so float32
# products default to full precision.  The integer-exact frontend products
# (pyramid, IC-angle moments) also pass ``precision=HIGHEST`` at the call,
# so extraction parity never depends on this process-global setting; the
# bf16 products (BRIEF one-hot, bit-plane Hamming) are exact by
# construction and unaffected.  The default is only set when nobody has
# configured the flag.
if _jax.config.jax_default_matmul_precision is None:
    _jax.config.update("jax_default_matmul_precision", "highest")

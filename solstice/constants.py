"""Capacity and algorithm constants.

Analog of the reference's compile-time configuration header
(solr/Consts.h): capacity caps (NB_MAX_PRIMITIVES ~1M, NB_MAX_MATERIALS,
NB_MAX_LAMPS ~512, NB_MAX_ITERATIONS ~20 bounce cap) and epsilons.  Here
capacities are *defaults* for padded SoA array sizes — XLA wants static
shapes, so scenes are padded up to a lane-friendly size; inert padding
(negative radius, degenerate triangle) never hits, so no count scalars are
needed inside kernels.
"""

# Geometric epsilons (f32-safe).
RAY_EPS = 1e-4          # t_min for secondary rays / shadow ray offset
INTERSECT_EPS = 1e-8    # degenerate denominator guard
NORMAL_EPS = 1e-12      # normalization guard

# Default capacities (soft: builders grow arrays in aligned chunks).
MAX_BOUNCES_DEFAULT = 4         # reference caps at NB_MAX_ITERATIONS ~20
MAX_LIGHTS_DEFAULT = 8          # reference NB_MAX_LAMPS ~512; pad per scene
PAD_ALIGN = 8                   # sublane alignment for f32 SoA arrays
PAD_ALIGN_KERNEL = 128          # lane alignment for Pallas-visible arrays

# BVH
BVH_LEAF_SIZE = 8               # primitives per leaf (lane-friendly)

# Texture atlas
MAX_TEXTURE_DIM = 4096

# Reserved material conventions (reference: material-ID conventions in
# solr/Consts.h, e.g. default/light/skybox materials).
DEFAULT_MATERIAL = 0

# Far value used as "no hit" sentinel.
T_FAR = 3.0e38

# Dead-ray parking spot: far outside any scene so packet bundles of
# parked rays cull to ZERO candidate blocks and retired tiles cost
# almost nothing (solstice.ops.render / ops.packet).  Any ray whose
# origin x exceeds PARK_THRESHOLD is treated as parked by the packet
# cull's live-mask detection.
PARK_POS = 1.0e8
PARK_DIR = 0.5773502691896258  # 1/sqrt(3), per component
PARK_THRESHOLD = 1.0e7

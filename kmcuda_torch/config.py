"""Constants the k-means and kNN paths read, with the values of
``kmcuda_tpu.config``.

Only what this package runs is here; the TPU tile and lane knobs have no
counterpart on the GPU (the kernels mask their own ragged edges, so
nothing is padded to chunk or lane multiples).  The kNN layout keeps the
JAX package's tile sizes, so both packages plan the same layout.
"""

#: Yinyang group count = YINYANG_T * clusters (reference default).
DEFAULT_YINYANG_T = 0.1

#: Yinyang is disabled when tolerance >= this value.
YINYANG_MIN_TOLERANCE = 0.11

#: Tolerance of the k-means that clusters the centroids into Yinyang groups.
YINYANG_GROUP_TOLERANCE = 0.02

#: The Lloyd draft runs until at most this fraction of the samples is
#: reassigned in an iteration; then the Yinyang loop takes over.
YINYANG_DRAFT_REASSIGNMENTS = 0.11

#: Default AFK-MC2 Markov chain length.
AFKMC2_DEFAULT_M = 200

#: Centroids per progress line of the k-means++ / AFK-MC2 loops
#: (verbosity >= 1, when k exceeds it).  Results do not depend on it.
INIT_SEGMENT_CENTROIDS = 256

#: Safety cap on Lloyd iterations.
DEFAULT_MAX_ITERATIONS = 65535

#: Stop when the reassignment count has not improved its running best by
#: at least mark/64 for this many consecutive iterations (the churn floor
#: of reduced precision can sit above the tolerance).  None disables it.
STAGNATION_PATIENCE = 50

# ---- size limits (the reference's uint32 layout constraints) -------------

MAX_SAMPLES = 2**32 - 1
#: Assignments are int32 tensors here (torch has almost no uint32
#: arithmetic) and id == k marks an invalid row, so k stays below 2**31 - 1.
MAX_CLUSTERS = 2**31 - 2
MAX_FEATURES = 2**16
MAX_CLUSTERS_X_FEATURES = 2**32

#: Rows per step of the compacted delta walk (ops.compact.delta_compacted).
DEFAULT_SAMPLE_CHUNK = 2048

#: Additive score marking dead centroids; never wins the argmin.
PAD_PENALTY = 1e30

#: Above this fraction of previously moved rows an iteration runs the dense
#: arm (full segment sum) instead of the compacted delta.
DELTA_DENSE_FRACTION = 0.35

# ---- kNN layout (models/knn.plan_pruned) -----------------------------------

#: Below 2 * LANE samples kNN runs the brute-force search.
LANE = 128

#: Queries per chunk of the pruned walk (the pruning granularity), capped
#: by the member tile; and member-tile rows of the brute-force search.
KNN_TILE_Q = 512
KNN_TILE_M = 2048

#: Member rows per step of the pruned walk (group = this / tile_m tiles).
KNN_TILE_GROUP_ROWS = 4096

#: Queries per host batch of the pruned search.  Results do not depend on
#: it; it bounds the work of one batch's walk launch.
KNN_QUERY_BATCH = 65536

#: Above this many clusters the layout relabels clusters by a projection
#: sort instead of the greedy nearest-neighbour tour.
KNN_TOUR_MAX_K = 4096

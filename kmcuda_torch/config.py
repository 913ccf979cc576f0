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

#: Rows are int32 wherever the port indexes them (the segment sum's
#: cluster-sorted permutation, the kNN positions and neighbour tensors), so
#: n stops below 2**31, where the reference's uint32 layout stops below
#: 2**32.  Row *offsets* (row * features) are 64-bit everywhere.
MAX_SAMPLES = 2**31 - 1
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

# ---- Yinyang schedule (ops/yinyang.yy_run) ----------------------------------
# Every knob below moves wall time or memory only: bounds never feed the
# argmin, so the trajectory is Lloyd's under any setting.

#: When more than this fraction of the samples are global-filter candidates,
#: the iteration assigns every row (one Lloyd pass, ungathered) instead of
#: tightening and gathering the candidates.  The lowest candidate fraction
#: at which a sparse iteration of the loop was measured to cost one dense
#: iteration on the H100, on the filter-friendly deep tail in fp32 and
#: bf16 storage (``chip_profile.py crossover``, PERF.md §5), rounded down
#: to a multiple of 0.05 for the spread between runs.
YY_DENSE_FRACTION = 0.75

#: Dense iterations keep the lower bounds (a "plain" pass: u refreshed, l
#: kept) and refresh them on a backoff: while each refresh is followed by
#: another dense iteration, the number of plain iterations before the next
#: refresh doubles, up to this many; a sparse iteration resets it to 1.
YY_REFRESH_BACKOFF_MAX = 64

#: Sparse iterations refresh the passed rows' lower bounds when the extra
#: candidates that stale bounds admitted since the last refresh (summed over
#: the iterations) reach this multiple of the previous passed count: the
#: group-panel product a refresh adds per passed row against the one
#: assignment row each extra candidate costs per iteration (rent or buy).
YY_SPARSE_REFRESH_SURCHARGE = 1.2

#: The tighten (exact own-centroid distance of each candidate) is kept only
#: while it prunes at least this fraction of the candidates; otherwise it is
#: skipped for a period that doubles up to YY_REFRESH_BACKOFF_MAX, and every
#: candidate goes to the assignment kernel.
YY_TIGHTEN_MIN_PRUNE = 0.33

#: Above this many bytes of (n, G) fp32 lower bounds they are stored in
#: bfloat16, rounded down (ops/yinyang.lower_cast), which halves the largest
#: Yinyang state at the cost of a looser filter.
YY_BOUNDS_F32_MAX_BYTES = 1 << 31

#: Filter triage (0 = normal; 1 = every valid row is a candidate; 2 = also
#: skip the tighten's re-test); both refresh every bound they touch.  For
#: debugging the filter's soundness only.
YY_DEBUG_MODE = 0

# ---- Yinyang wall-clock controller (models/yinyang.run) --------------------
# The loop's dense/sparse choice is a work model; whether a gathered sparse
# iteration beats a Lloyd pass is measured: the driver times windows of
# iterations and revokes the loop's permission to go sparse when a
# sparse-heavy window loses to the measured Lloyd floor.

#: Master switch of the controller and the budget gates.
YY_WALL_CONTROLLER = True

#: Below this iteration budget (before the draft, or left after it) the run
#: stays on Lloyd: grouping and the first full bound refresh cost several
#: Lloyd iterations that a short run cannot earn back.
YY_MIN_REMAINING = 32

#: Iterations of a window on probation: the first judged window and every
#: re-probe of the sparse branch.  Windows that pass grow 4x, up to
#: YY_WINDOW_MAX_ITERS.
YY_PROBE_ITERS = 8

#: The longest window between two controller decisions.
YY_WINDOW_MAX_ITERS = 256

#: Revoke the sparse branch when a sparse-heavy window's seconds per
#: iteration exceed the Lloyd floor by this factor; re-probe it after
#: YY_REPROBE_ITERS dense iterations, the interval doubling at every
#: re-probe up to YY_REPROBE_ITERS_MAX.
YY_BAILOUT_MARGIN = 1.02
YY_REPROBE_ITERS = 128
YY_REPROBE_ITERS_MAX = 2048

#: The Lloyd handover: an iteration right after a full dense refresh that
#: still finds more than YY_DENSE_FRACTION of the rows candidates hands
#: the run to the Lloyd loop, which gives the bound path back once its
#: walls reach 2^j times the refresh's surcharge over the Lloyd floor (j:
#: the earlier handovers of the call).  Off, the bound path runs to the end.
YY_LLOYD_HANDOVER = True

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

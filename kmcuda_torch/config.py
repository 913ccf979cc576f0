"""Constants the Lloyd path reads, with the values of ``kmcuda_tpu.config``.

Only what this package runs is here; the TPU tile and lane knobs have no
counterpart on the GPU (the kernels mask their own ragged edges, so
nothing is padded to chunk or lane multiples).
"""

#: Yinyang group count = YINYANG_T * clusters (reference default).
DEFAULT_YINYANG_T = 0.1

#: Yinyang is disabled when tolerance >= this value.
YINYANG_MIN_TOLERANCE = 0.11

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

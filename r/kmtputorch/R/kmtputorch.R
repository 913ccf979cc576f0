# R binding for kmcuda_torch, the PyTorch/CUDA port of libKMTPU, with the
# contract of the reference binding (reference src/r.cc) and of r/kmtpu:
#  - `samples` may be one numeric matrix or a list of matrices which are
#    rbind-ed (r.cc:80-139);
#  - doubles are converted to float32 (r.cc:121-139);
#  - assignments are returned 1-based (r.cc:303-316);
#  - the result is a named list(centroids, assignments[, average_distance])
#    (r.cc:317-332); knn returns a 1-based integer matrix (r.cc:406-416),
#    with NA for the neighbours of a row with non-finite features.
#
# Implementation: the kmcuda_torch Python package via reticulate.  Numpy
# arrays run on the CUDA cards the `device` mask selects, their rows split
# over them (there is no CPU fallback).  Under KMTPU_PLATFORM=cpu the arrays go in as CPU tensors
# (torch$from_numpy) and the calls run on the CPU, so the suite runs on a
# machine without a card.

.kmtputorch_env <- new.env(parent = emptyenv())

.module <- function(name) {
  if (is.null(.kmtputorch_env[[name]])) {
    .kmtputorch_env[[name]] <- reticulate::import(name, delay_load = FALSE)
  }
  .kmtputorch_env[[name]]
}

.on_cpu <- function() identical(Sys.getenv("KMTPU_PLATFORM"), "cpu")

# numpy array of `x` in `dtype`, as a CPU tensor under KMTPU_PLATFORM=cpu
.to_py <- function(x, dtype) {
  arr <- .module("numpy")$asarray(x, dtype = dtype)
  if (.on_cpu()) .module("torch")$from_numpy(arr) else arr
}

# an R array of a result (a tensor, or a numpy array reticulate converted)
.to_r <- function(v) {
  if (inherits(v, "python.builtin.object")) v$numpy() else v
}

# 1-based integer ids; the kNN sentinel (-1 in an int32 tensor,
# 0xFFFFFFFF in a uint32 array) becomes NA
.one_based <- function(ids) {
  ids <- as.numeric(.to_r(ids))
  ids[ids < 0 | ids >= 4294967295] <- NA
  as.integer(ids + 1)
}

.flatten_samples <- function(samples) {
  if (is.list(samples)) {
    # rbind path (r.cc:80-139): total row count may exceed a single
    # matrix's limits
    for (m in samples) {
      if (!is.matrix(m)) stop("samples list members must be matrices")
    }
    samples <- do.call(rbind, samples)
  }
  if (!is.matrix(samples)) stop("samples must be a matrix or list of matrices")
  storage.mode(samples) <- "double"
  samples
}

#' K-means clustering on a CUDA card.
#'
#' @param samples numeric matrix (samples x features) or list of matrices.
#' @param clusters number of clusters.
#' @param tolerance stop when fewer than this fraction reassigns.
#' @param init "k-means++", "random", "afkmc2" or a matrix of centroids.
#' @param yinyang_t Yinyang group fraction; 0 disables Yinyang.
#' @param metric "L2" or "cos".
#' @param average_distance also return the mean sample-centroid distance.
#' @param seed integer random seed.
#' @param device device bitmask (0 = all cards; the rows are split over
#'   the cards it selects).
#' @param verbosity 0 silent, 1 progress, 2 debug.
#' @return list(centroids, assignments[, average_distance]); assignments
#'         are 1-based.
kmeans_torch <- function(samples, clusters, tolerance = 0.01,
                         init = "k-means++", yinyang_t = 0.1, metric = "L2",
                         average_distance = FALSE, seed = NULL, device = 0L,
                         verbosity = 0L) {
  x <- .flatten_samples(samples)
  if (is.matrix(init)) {
    init <- .to_py(init, "float32")
  }
  res <- .module("kmcuda_torch")$kmeans_torch(
    .to_py(x, "float32"), as.integer(clusters), tolerance = tolerance,
    init = init, yinyang_t = yinyang_t, metric = metric,
    average_distance = average_distance,
    seed = if (is.null(seed)) NULL else as.integer(seed),
    device = as.integer(device), verbosity = as.integer(verbosity))
  out <- list(centroids = .to_r(res[[1]]),
              # 1-based indices, like the reference (r.cc:303-316)
              assignments = .one_based(res[[2]]))
  if (average_distance) {
    out$average_distance <- res[[3]]
  }
  out
}

#' Exact k-nearest-neighbors using k-means structure for pruning.
#'
#' @return integer matrix (samples x k) of 1-based neighbor indices sorted
#'         by ascending distance, excluding the sample itself; NA in the
#'         rows of samples with non-finite features.
knn_torch <- function(k, samples, centroids, assignments, metric = "L2",
                      device = 0L, verbosity = 0L) {
  x <- .flatten_samples(samples)
  nb <- .module("kmcuda_torch")$knn_torch(
    as.integer(k), .to_py(x, "float32"), .to_py(centroids, "float32"),
    .to_py(as.integer(assignments) - 1L,
           if (.on_cpu()) "int32" else "uint32"),
    metric = metric, device = as.integer(device),
    verbosity = as.integer(verbosity))
  matrix(.one_based(nb), nrow = nrow(x), byrow = FALSE)
}

# kmcuda-compatible names (the reference R binding exports kmeans_cuda /
# knn_cuda, r.cc:177-181)
kmeans_cuda <- kmeans_torch
knn_cuda <- knn_torch

# testthat suite for the kmtputorch R binding, the suite of
# r/kmtpu/tests/test-kmtpu.R (itself the reference's src/test.R: parity vs
# R's kmeans(iter.max=1), the list-of-matrices rbind path, AFK-MC2 /
# import init, 1-based index checks, average_distance cross-check, cosine
# knn shape/uniqueness) plus NA neighbours for non-finite rows.
#
# Self-bootstraps when run via `Rscript test-kmtputorch.R`.  Requires:
# testthat, reticulate, and a Python environment with the kmcuda_torch
# package importable; a CUDA card, or KMTPU_PLATFORM=cpu to run on the CPU.

library(testthat)

if (exists("kmtputorch_testing")) {
  source(file.path(kmtputorch_root, "R", "kmtputorch.R"))

  reassignment_fraction <- function(samples, result) {
    # one extra R kmeans step seeded from our centroids must move almost
    # nobody (the reference's validation, test.R:13-17)
    fit <- kmeans(samples, result$centroids, iter.max = 1,
                  algorithm = "Lloyd")
    mean(fit$cluster != result$assignments)
  }

  context("K-means")
  test_that("Random", {
    set.seed(42)
    samples <- replicate(4, runif(16000))
    result <- kmeans_torch(samples, 50, tolerance = 0.01, init = "random",
                           seed = 777, yinyang_t = 0)
    expect_equal(length(result$assignments), 16000)
    # 1-based contract (r.cc:303-316)
    expect_gte(min(result$assignments), 1)
    expect_lte(max(result$assignments), 50)
    expect_lt(reassignment_fraction(samples, result), 0.01)
  })

  test_that("KmeansPlusPlusLloyd", {
    set.seed(42)
    samples <- replicate(4, runif(16000))
    result <- kmeans_torch(samples, 50, init = "k-means++", seed = 777,
                           yinyang_t = 0)
    expect_lt(reassignment_fraction(samples, result), 0.01)
  })

  test_that("MultiSamples", {
    # the rbind path (r.cc:80-139): a list of matrices is concatenated
    set.seed(42)
    samples1 <- replicate(4, runif(16000))
    samples2 <- replicate(4, runif(16000))
    result <- kmeans_torch(list(samples1, samples2), 50,
                           init = "k-means++", seed = 777)
    expect_equal(length(result$assignments), 32000)
    expect_lt(reassignment_fraction(rbind(samples1, samples2), result),
              0.01)
  })

  test_that("AFK-MC2", {
    set.seed(42)
    samples <- replicate(4, runif(16000))
    result <- kmeans_torch(samples, 50, tolerance = 0.01, init = "afkmc2",
                           seed = 777)
    expect_lt(reassignment_fraction(samples, result), 0.01)
  })

  test_that("ImportCentroids", {
    set.seed(42)
    samples <- replicate(4, runif(16000))
    centroids <- replicate(4, runif(50))
    result <- kmeans_torch(samples, 50, tolerance = 0.01, init = centroids,
                           seed = 777)
    expect_lt(reassignment_fraction(samples, result), 0.01)
  })

  test_that("RandomPlusAverageDistance", {
    set.seed(42)
    samples <- replicate(4, runif(16000))
    result <- kmeans_torch(samples, 50, tolerance = 0.01, init = "random",
                           seed = 777, average_distance = TRUE)
    d <- sqrt(rowSums((samples -
                       result$centroids[result$assignments, ])^2))
    expect_equal(result$average_distance, mean(d), tolerance = 1e-4)
    expect_gt(result$average_distance, 0)
  })

  context("K-nn")
  test_that("Cosine", {
    set.seed(42)
    samples <- replicate(4, runif(16000))
    samples <- samples / sqrt(rowSums(samples^2))
    cls <- kmeans_torch(samples, 50, tolerance = 0.01, metric = "cos",
                        seed = 777, yinyang_t = 0)
    lapply(rowSums(cls$centroids^2),
           function(r) expect_equal(r, 1, tolerance = 1e-4))
    result <- knn_torch(20, samples, cls$centroids, cls$assignments,
                        metric = "cos")
    expect_equal(dim(result), c(16000L, 20L))
    expect_true(is.matrix(result))
    # 1-based, self-excluded, unique per row
    expect_gte(min(result), 1)
    expect_lte(max(result), 16000)
    expect_false(any(result == seq_len(16000)))
    expect_equal(sum(apply(result, 1,
                           function(r) length(unique(r)))), 16000 * 20)
  })

  test_that("NonFiniteRows", {
    # a row with a non-finite feature gets the invalid id k + 1 and no
    # neighbours: NA on both routes (0xFFFFFFFF from numpy, -1 from a
    # tensor), never 0 or a real row
    set.seed(42)
    samples <- replicate(4, runif(4000))
    samples[c(7, 3001), 2] <- NaN
    cls <- kmeans_torch(samples, 20, tolerance = 0.01, seed = 777,
                        yinyang_t = 0)
    expect_equal(cls$assignments[c(7, 3001)], c(21L, 21L))
    result <- knn_torch(5, samples, cls$centroids, cls$assignments)
    expect_true(all(is.na(result[c(7, 3001), ])))
    expect_false(any(is.na(result[-c(7, 3001), ])))
    expect_gte(min(result, na.rm = TRUE), 1)
    expect_lte(max(result, na.rm = TRUE), 4000)
  })
} else {
  kmtputorch_testing <- TRUE
  this_file <- function() {
    args <- commandArgs(trailingOnly = FALSE)
    match <- grep("--file=", args)
    if (length(match) > 0) {
      return(normalizePath(sub("--file=", "", args[match])))
    }
    normalizePath(sys.frames()[[1]]$ofile)
  }
  kmtputorch_root <- dirname(dirname(this_file()))
  test_results <- test_file(this_file(), reporter = "summary")
  if (any(as.data.frame(test_results)$failed > 0)) quit(status = 1)
}

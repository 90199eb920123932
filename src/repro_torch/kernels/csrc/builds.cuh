// The builds of one kernel source, as its init grants them and as the
// checker reads them (repro_torch/analysis/kernels.py).
//
// Each source keeps one table of REPRO_BUILD(granted dynamic shared
// memory, kernel<template arguments>) entries: every instantiation it
// launches.  On the CPU the checker reads the table's lines from the
// source (rule H003: a plan's build must be one of them); on the card,
// <source>_init grants each entry its dynamic shared memory and
// <source>_attributes reads each entry's attributes (rule H004).
#pragma once

#include <cuda_runtime.h>

#ifndef REPRO_SMEM_LIMIT
#error "build with -DREPRO_SMEM_LIMIT=<bytes> (repro_torch/kernels/_build.py)"
#endif

namespace repro {

// Shared memory a CTA may opt into on the card (kernels/_build.py
// SMEM_LIMIT, passed by the build).
constexpr int kSmemLimit = REPRO_SMEM_LIMIT;

struct Build {
  const void* fn;
  long long dyn_smem;  // granted by the init; 0 keeps the 48 KB default
};

#define REPRO_BUILD(smem, ...) \
  ::repro::Build { (const void*)(&__VA_ARGS__), static_cast<long long>(smem) }

// Once, when the library loads (never inside a graph capture): each build
// may take the dynamic shared memory its entry grants.
template <int N>
cudaError_t grant(const Build (&builds)[N]) {
  for (const Build& b : builds) {
    if (b.dyn_smem <= 0) continue;
    const cudaError_t err = cudaFuncSetAttribute(
        b.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(b.dyn_smem));
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Build `index`'s attributes into out[0..7]: registers per thread, static
// shared bytes, local bytes per thread (spills and stack), the most
// threads a block may have, the most dynamic shared bytes a launch may
// take (as granted), the blocks of `threads` threads with `dyn_smem`
// dynamic shared bytes resident on one SM (with `cluster` > 1: the
// clusters of that many such CTAs the card places at once; -1 for
// `threads` 0), the binary's SM version, and the table's length (written
// first, also for an index past it).  Returns a cudaError_t.
template <int N>
int attributes(const Build (&builds)[N], int index, int threads,
               long long dyn_smem, int cluster, long long* out) {
  out[7] = N;
  if (index < 0 || index >= N) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = builds[index].fn;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<long long>(a.sharedSizeBytes);
  out[2] = static_cast<long long>(a.localSizeBytes);
  out[3] = a.maxThreadsPerBlock;
  out[4] = a.maxDynamicSharedSizeBytes;
  out[6] = a.binaryVersion;
  int resident = -1;
  if (threads > 0 && cluster <= 1) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, fn, threads, static_cast<size_t>(dyn_smem));
  } else if (threads > 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(cluster), 1, 1);
    cfg.blockDim = dim3(static_cast<unsigned>(threads), 1, 1);
    cfg.dynamicSmemBytes = static_cast<size_t>(dyn_smem);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&resident, fn, &cfg);
  }
  out[5] = resident;
  return static_cast<int>(err);
}

}  // namespace repro

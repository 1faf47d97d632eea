// K1 (march), K2 (occlusion) and K3 (surface pass, slot mode and AD mode):
// the sphere-trace kernels of the forward frame, dense and culled.
//
// Replaces: fraytracer_tpu/ops/pallas/march_kernel.py::_build_kernel, the
// three programs launched by pallas_march_raw — mode="march" (kernel,
// :1637), mode="occlusion" (same body, hit output only) and mode="surface"
// (surf_kernel :1606 with surface_eval_slot :1022 for plans of min/max
// alone, surface_eval :1304 for plans with a smooth union) — in their dense
// form (cull=False: every primitive each step) and their culled form
// (per-tile candidate tables: culled_pass :877-980 with _pair_window :641
// in K1/K2, culled_sp :1051-1144 and the normal sweep :1231-1269 in K3
// slot mode, culled_sp :1359-1456 in K3 AD mode).
//
// What bounds K1/K2 on an H100: instruction issue and latency, not bytes.  A
// dense step of one ray evaluates every primitive (about 30 flops and 2
// square roots per torus, 1002 primitives on the benchmark scene): its
// cost is the issue slots a primitive takes, the dispatch on its kind and
// the lanes that idle in a warp whose other lanes still march.  A culled
// step evaluates the dense rest plus the window chunks of its warp's tile
// table (tens of candidates) behind a chain of dependent reads: program,
// group, pair record, chunk keys, then the rows.  Culled warps run as long
// as their slowest lane (58% of the lane-steps are useful), and two
// thirds of a frame's blocks hold no lane that marches, so the fixed cost
// of a block counts too.
//
// Design of the dense form (march_dense_kernel, below march_kernel):
// - the host lowers each group's entries as runs of one kind (slots are
//   kind-major and a group's members ascend: no entry moves, a sumexp
//   group's sum keeps its order) and packs their rows at their kind's
//   width rounded up to 16 bytes (a torus 32 bytes, a sphere 16: 32,032
//   bytes for the benchmark's 1002 entries);
// - a block stages the program, the runs and the packed rows (one bulk
//   copy on its mbarrier, sized from shapes alone: cull.py
//   dense_stage_plan); rows that do not fit are read from device memory
//   through the same code;
// - a group dispatches once per run on the kind, keeps 4 rows in flight on
//   two accumulators in a min/max run (exact in any order; a warp reads
//   one row at a time, a broadcast) and adds a sumexp run in order; the
//   march distance takes sqrt.approx (FT_DENSE_FAST_ROOTS), held to the
//   plain version's bounds as the culled form is;
// - lane refill over a persistent grid: a lane whose ray ends takes the
//   next ray index from a counter (one warp-aggregated atomicAdd a
//   refill), so no lane idles while its warp marches on; a lane counts its
//   own steps against max_steps (the pattern of Aila & Laine,
//   "Understanding the Efficiency of Ray Traversal on GPUs", HPG 2009,
//   persistent threads).  The culled form keeps fixed lanes: its window is
//   warp-collective.
//
// Design of the culled form (march_kernel):
// - one thread per ray over a 1-D grid of FT_BLOCK = 128 threads, 6
//   blocks an SM (80 registers): rays are flat [N] (origin and direction
//   [N, 3]); the grid masks the ragged end, and lanes past N stay in the
//   loop as inactive lanes (the window is warp-collective).  Blocks are
//   tile-aligned (a tile = 1024 lanes = one 32x32 screen block = 8
//   blocks), so a block reads one tile's tables;
// - staged once per block (stage_begin): one thread starts 1-D bulk
//   asynchronous copies (cp.async.bulk, completing on an mbarrier) of each
//   culled pair's tile slices — the candidate table, the chunk keys, the
//   suffix minima — into shared memory; meanwhile every thread loads its
//   ray and copies the program, the dense entries (rows outside every
//   pair, as 48-byte rows) and the slices too small for a bulk copy.  The
//   host sizes the shared memory from shapes alone (cull.py stage_plan, no
//   device read): 13.0 KB a block at m 256, 25.4 KB at m 512; pairs are
//   staged in program order while they fit 227 KB, the rest is read from
//   device memory through the same code (generic loads);
// - the scene is not compiled into the kernel: the host lowers the CSG
//   plan to a small program (groups of primitives with a min/max/sumexp
//   reduction + the tree in postfix) that every thread interprets with a
//   fixed-depth value stack (ft_sdf.cuh march_distance);
// - a culled group's window is computed per warp (WINDOW_LANES = 32: the
//   plain version reproduces the step sequence at that granularity): two
//   redux for the lanes' axial range, each lane tests its chunks' keys, a
//   ballot finds the hull, and only the bounds the group's reduction
//   needs are reduced, before the rows so that they overlap them;
// - the candidate loop is specialised by primitive kind (one dispatch per
//   pair and step, not per row), reads a row as 16-byte words from shared
//   memory (a warp reads one row: a broadcast), keeps 4 rows in flight on
//   two accumulators, and takes sqrt.approx for the march distance (dense
//   entries beyond the few a block stages, read from device memory, keep
//   IEEE roots);
// - the march loop runs while any lane of the warp is active; a lane
//   evaluates once per iteration while active, so a cap of max_steps
//   iterations reproduces the TPU tile loop's i < max_steps per lane;
// - omega-relaxed stepping with the overstep revert and the
//   budget-crossing rule of march_kernel.py:1697-1722, exactly;
// Measured and left out for the culled form: 256-thread blocks, 8 rows in
// flight, blocks without an active lane skipping the staging, copying only
// a table's first ceil8(count) rows (PERF.md has the figures).
//
// Design of K3 (the section below has the details): the same tile-aligned
// blocks and the same staging (the dense form: the packed rows and each
// entry's material and slot); the block's hit lanes compacted onto its
// first warps; a whole-list scan of each pair, or of each run of the dense
// form, specialised by kind, with exact roots; the winner's gradient from
// its staged row (the dense form: from device memory, once).
#include <algorithm>
#include <type_traits>

#include "ft_sdf.cuh"

// ---------------------------------------------------------------------------
// K1 / K2
// ---------------------------------------------------------------------------

// mbarrier + bulk-copy primitives (PTX; sm_90)
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// bytes: a multiple of 16; dst and src 16-byte aligned
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ int round16(int b) { return (b + 15) & ~15; }

template <typename T>
__device__ __forceinline__ void stage_words(unsigned char* smem, int off,
                                            const T* src, int n) {
  T* dst = (T*)(smem + off);
  for (int j = threadIdx.x; j < n; j += FT_BLOCK) dst[j] = __ldg(src + j);
}

// The block's prologue: thread 0 starts the bulk copies of the staged
// pairs' tile slices (table; keys and hsuf where their size is a multiple
// of 16 bytes — the host decides from m); every thread then copies its
// share of the program (one record an op, its group's fields folded in),
// the dense entries, the small slices that do not qualify, and the pair
// records.  The caller loads its ray meanwhile and
// calls stage_wait before its first scene evaluation.
__device__ __forceinline__ void stage_begin(unsigned char* smem,
                                            const FtProgram& P,
                                            const FtCull& C, const FtStage& S,
                                            int tile) {
  const unsigned bar = smem_addr(smem);
  if (S.bulk_bytes > 0 && threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_expect_tx(bar, (unsigned)S.bulk_bytes);
    for (int q = 0; q < C.n_pairs; ++q) {
      const int off = S.pair_off[q];
      if (off < 0) continue;
      const FtPair& g = C.pairs[q];
      const int m = g.m, chunks = m / FT_CAND_UNROLL;
      const int tab_b = m * FT_TABLE_W * 4, keys_b = 2 * chunks * 4;
      bulk_copy(smem + off, g.table + (size_t)tile * m * FT_TABLE_W, tab_b,
                bar);
      if (S.bulk_keys >> q & 1) {
        bulk_copy(smem + off + tab_b, g.keys + (size_t)tile * 2 * chunks,
                  keys_b, bar);
      }
      if (S.bulk_hsuf >> q & 1) {
        bulk_copy(smem + off + tab_b + round16(keys_b),
                  g.hsuf + (size_t)tile * chunks, chunks * 4, bar);
      }
    }
  }
  SOp* sops = (SOp*)(smem + S.ops_off);
  for (int i = threadIdx.x; i < P.n_ops; i += FT_BLOCK) {
    SOp o = {__ldg(P.ops + 2 * i), __ldg(P.ops + 2 * i + 1), 0, 0, 0, 0, 0,
             __ldg(P.op_k + i)};
    if (o.op == OP_GROUP) {
      const int g = o.arg;
      o.e0 = __ldg(P.groups + 3 * g);
      o.e1 = __ldg(P.groups + 3 * g + 1);
      o.gop = __ldg(P.groups + 3 * g + 2);
      o.k = __ldg(P.group_k + g);
      if (C.n_pairs > 0 && o.gop != G_SUMEXP) {
        o.q0 = __ldg(P.group_pairs + 2 * g);
        o.q1 = __ldg(P.group_pairs + 2 * g + 1);
      }
    }
    sops[i] = o;
  }
  for (int e = threadIdx.x; e < S.ents; e += FT_BLOCK) {
    float* row = (float*)(smem + S.ents_off) + e * FT_TABLE_W;
    for (int j = 0; j < FT_PSTRIDE; ++j) {
      row[j] = __ldg(P.ent_params + (size_t)e * FT_PSTRIDE + j);
    }
    row[FT_PSTRIDE] = __int_as_float(__ldg(P.ent_kind + e));
    row[FT_PSTRIDE + 1] = 0.f;
  }
  SPair* sp = (SPair*)(smem + 16);
  for (int q = 0; q < C.n_pairs; ++q) {
    const FtPair& g = C.pairs[q];
    const int off = S.pair_off[q];
    const int m = g.m, chunks = m / FT_CAND_UNROLL;
    const int tab_b = m * FT_TABLE_W * 4, keys_b = 2 * chunks * 4;
    const float* keys = g.keys + (size_t)tile * 2 * chunks;
    const float* hsuf = g.hsuf + (size_t)tile * chunks;
    if (off >= 0) {
      if (!(S.bulk_keys >> q & 1)) {
        stage_words(smem, off + tab_b, keys, 2 * chunks);
      }
      if (!(S.bulk_hsuf >> q & 1)) {
        stage_words(smem, off + tab_b + round16(keys_b), hsuf, chunks);
      }
    }
    if (threadIdx.x == q) {
      const float4 misc = __ldg((const float4*)g.misc + tile);
      SPair r;
      r.tab = off >= 0 ? (const float*)(smem + off)
                       : g.table + (size_t)tile * m * FT_TABLE_W;
      r.keys = off >= 0 ? (const float*)(smem + off + tab_b) : keys;
      r.hsuf = off >= 0
                   ? (const float*)(smem + off + tab_b + round16(keys_b))
                   : hsuf;
      r.clamp = misc.z;
      r.count = misc.x;
      r.m = m;
      r.kind = g.kind;
      r.group_size = g.group_size;
      r.pad_ = 0;
      sp[q] = r;
    }
  }
}

__device__ __forceinline__ void stage_wait(unsigned char* smem,
                                           const FtStage& S) {
  __syncthreads();  // the threads' own copies, and the barrier's init
  if (S.bulk_bytes > 0) mbar_wait(smem_addr(smem), 0);
}

template <typename Hook>
__global__ void __launch_bounds__(FT_BLOCK, 6)
march_kernel(const float* __restrict__ origin, const float* __restrict__ dir,
             const float* __restrict__ length, const float* __restrict__ eps,
             const float* __restrict__ t0, const float* __restrict__ sign,
             int n, FtProgram P, FtCull C, FtStage S, int max_steps,
             float omega, int occlusion,
             float* __restrict__ t_out, int* __restrict__ hit_out,
             float* __restrict__ d_out, int* __restrict__ steps_out,
             unsigned long long* __restrict__ sections) {
  extern __shared__ __align__(16) unsigned char ft_smem[];
  Hook hook;
  if constexpr (ft_timed<Hook>::value) {
    for (int s = 0; s < SEC_N; ++s) hook.acc[s] = 0;
    for (int s = 0; s < CNT_N; ++s) hook.cnt[s] = 0;
    hook.last = clock64();
  }
  const int i = blockIdx.x * FT_BLOCK + threadIdx.x;
  // the block's tile: FT_TILE is a multiple of FT_BLOCK
  const int tile = blockIdx.x / (FT_TILE / FT_BLOCK);
  stage_begin(ft_smem, P, C, S, tile);
  const bool valid = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float L = 0.f, t = 0.f, sgn = 1.f;
  Lane lane;
  lane.oa = lane.ca = 0.f;
  lane.eps = 1.f;
  if (valid) {
    // all loads are issued before the wait below and overlap the copies
    ox = origin[3 * i]; oy = origin[3 * i + 1]; oz = origin[3 * i + 2];
    dx = dir[3 * i]; dy = dir[3 * i + 1]; dz = dir[3 * i + 2];
    L = length[i];
    t = t0[i];
    lane.eps = eps[i];
    if (sign != nullptr) sgn = sign[i];
    if (C.n_pairs > 0) {
      lane.oa = C.oa[i];
      lane.ca = C.ca[i];
    }
  }
  stage_wait(ft_smem, S);
  const MarchCtx X = {P, S, ft_smem, C.early_out};
  const float e = lane.eps;
  bool active = valid && (L > 0.f) && (t < L);
  bool hit = false;
  float d_last = FT_BIG;
  int steps = 0;
  const bool relaxed = omega > 1.f;
  float d_start = FT_BIG, step_taken = 0.f;
  ft_tick(hook, SEC_LOAD);

  for (int it = 0; it < max_steps; ++it) {
    ft_tick(hook, SEC_STEP);
    if (!__any_sync(FT_FULL_MASK, active)) break;
    ft_count(hook, CNT_STEPS, 1);
    lane.t = t;
    lane.active = active;
    // every lane of the warp evaluates (the culled window is collective).
    // Per-lane sign: -1 marches inside the solid toward its exit surface.
    // The windows stay sound for such a lane: the bound of a primitive
    // that contains the point contains it too, so that primitive is never
    // window-skipped, and the capped union min is the true (negative)
    // distance there.
    const float d = sgn * march_distance(X, lane, ox + t * dx, oy + t * dy,
                                         oz + t * dz, hook);
    if (!active) continue;
    ++steps;
    if (relaxed) {
      // overstep: the relaxed step left the union of the two safety
      // spheres -> revert to the conservative landing point
      const bool over = step_taken > d_start + d;
      const bool is_hit = !over && d < e;
      const float step_rel = omega * d;
      // a relaxed step that would cross the budget falls back to d
      const float step_new = (t + step_rel >= L) ? d : step_rel;
      const float adv = (over || is_hit) ? 0.f : step_new;
      const float t_new = over ? (t - step_taken) + d_start : t + adv;
      const bool still = over || (!is_hit && t_new < L);
      if ((still && !over) || is_hit) d_last = d;
      step_taken = over ? d_start : adv;
      d_start = over ? d_start : d;
      t = t_new;
      hit = hit || is_hit;
      active = still;
    } else {
      const bool is_hit = d < e;
      const float t_new = is_hit ? t : t + d;
      const bool still = !is_hit && t_new < L;
      if (still || is_hit) d_last = d;
      t = t_new;
      hit = hit || is_hit;
      active = still;
    }
  }
  if (valid) {
    hit_out[i] = hit ? 1 : 0;
    steps_out[i] = steps;
    if (!occlusion) {
      t_out[i] = t;
      d_out[i] = d_last;
    }
  }
  if constexpr (ft_timed<Hook>::value) {
    // one report per warp: its lanes run in step
    hook.tick(SEC_STORE);
    if ((threadIdx.x & 31) == 0) {
      for (int s = 0; s < SEC_N; ++s) {
        atomicAdd(sections + s, (unsigned long long)hook.acc[s]);
      }
      for (int s = 0; s < CNT_N; ++s) {
        atomicAdd(sections + SEC_N + s, (unsigned long long)hook.cnt[s]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K1 / K2, the dense form
// ---------------------------------------------------------------------------

// Occupancy of the dense march: registers for FT_DENSE_THREADS threads an
// SM, in blocks as wide as the stage lets them be (the host's rule,
// cull.py dense_march_threads): 6 x 128 where six stages fit an SM (the
// benchmark tori's 32,256 bytes), 1 x 768 where one does (1,000 machined
// parts' 176,144).  The prologue's copies stride by blockDim.x and refill
// is per warp, so the width changes no output.

// A dense block's prologue: thread 0 starts the bulk copy of the packed
// rows where the plan stages them; every thread copies its share of the
// program (a group's record carries its run range in q0/q1), the runs and
// (K3) each entry's (material, slot).  Then a __syncthreads and, where the
// rows are staged, the barrier.
__device__ __forceinline__ void dense_stage_begin(unsigned char* smem,
                                                  const FtProgram& P,
                                                  const FtDenseStage& S) {
  const unsigned bar = smem_addr(smem);
  if (S.rows_off >= 0 && threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_expect_tx(bar, (unsigned)S.rows_bytes);
    bulk_copy(smem + S.rows_off, P.packed, (unsigned)S.rows_bytes, bar);
  }
  SOp* sops = (SOp*)(smem + S.ops_off);
  for (int i = threadIdx.x; i < P.n_ops; i += blockDim.x) {
    SOp o = {__ldg(P.ops + 2 * i), __ldg(P.ops + 2 * i + 1), 0, 0, 0, 0, 0,
             __ldg(P.op_k + i)};
    if (o.op == OP_GROUP) {
      const int g = o.arg;
      o.e0 = __ldg(P.groups + 3 * g);
      o.e1 = __ldg(P.groups + 3 * g + 1);
      o.gop = __ldg(P.groups + 3 * g + 2);
      o.k = __ldg(P.group_k + g);
      o.q0 = __ldg(P.group_runs + 2 * g);
      o.q1 = __ldg(P.group_runs + 2 * g + 1);
    }
    sops[i] = o;
  }
  int4* runs = (int4*)(smem + S.runs_off);
  for (int r = threadIdx.x; r < P.n_runs; r += blockDim.x) {
    runs[r] = __ldg((const int4*)P.runs + r);
  }
  if (S.ms_off >= 0) {
    int2* ms = (int2*)(smem + S.ms_off);
    for (int e = threadIdx.x; e < P.n_ent; e += blockDim.x) {
      ms[e] = __ldg((const int2*)P.ent_ms + e);
    }
  }
}

// The block's view once the copies are in (dense_stage_begin, a
// __syncthreads, the packed rows' barrier where they are staged).
// STAGED: the rows (and K3's pairs) in shared memory, named from the
// block's array itself so that the compiler emits shared-memory loads; else
// the rows from device memory (generic loads for the pairs).
template <bool STAGED>
__device__ __forceinline__ DenseCtx dense_ctx(const unsigned char* smem,
                                              const FtProgram& P,
                                              const FtDenseStage& S) {
  if constexpr (STAGED) {
    return {P, S, smem, (const float4*)(smem + S.rows_off),
            (const int2*)(smem + S.ms_off)};
  } else {
    return {P, S, smem, (const float4*)P.packed,
            S.ms_off >= 0 ? (const int2*)(smem + S.ms_off)
                          : (const int2*)P.ent_ms};
  }
}

// The rays of the dense march (below), as one argument.
struct DenseRays {
  const float *origin, *dir, *length, *eps, *t0;
  const float* sign;  // or null
  float* t_out;       // null for occlusion, as d_out
  int* hit_out;
  float* d_out;
  int* steps_out;
  int n, max_steps, occlusion;
  float omega;
};

// The dense march with lane refill over a persistent grid: a lane's march
// reads its own ray alone (no warp-collective window), so a lane whose ray
// ends takes the next one.  Each warp takes ray indices from the counter
// `next` with one atomicAdd per refill (ballot, popc, shuffle), in lane
// order; a lane counts its own steps against max_steps; a ray that does
// not march (a zero budget, t0 past it) is written out at once.  Every
// ray's outputs are those of a fixed lane, bit for bit.  `issued` (or
// null) receives the warps' march iterations, 32 evaluations each;
// `evals` (or null) the lane-steps, the scene evaluations the lanes made
// (a ray that does not march makes none): one atomicAdd a warp at exit.
template <bool STAGED>
__device__ __forceinline__ void march_dense_lanes(
    const unsigned char* smem, const FtProgram& P, const FtDenseStage& S,
    const DenseRays& R, int* __restrict__ next,
    unsigned long long* __restrict__ issued,
    unsigned long long* __restrict__ evals) {
  const DenseCtx X = dense_ctx<STAGED>(smem, P, S);
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const bool relaxed = R.omega > 1.f;
  Lane none;  // the dense groups read no window statistics
  none.oa = none.ca = none.t = 0.f;
  none.eps = 1.f;
  none.active = true;
  NoPrimHook hook;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float L = 0.f, t = 0.f, e = 1.f, sgn = 1.f;
  float d_last = FT_BIG, d_start = FT_BIG, step_taken = 0.f;
  int ray = 0, steps = 0;
  bool hit = false, active = false, done = false;
  unsigned long long iters = 0;
  unsigned lane_steps = 0;
  for (;;) {
    // refill every lane that neither marches nor has run out of rays
    unsigned need;
    while ((need = __ballot_sync(FT_FULL_MASK, !active && !done)) != 0u) {
      const int leader = __ffs(need) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(next, __popc(need));
      base = __shfl_sync(FT_FULL_MASK, base, leader);
      if (!active && !done) {
        ray = base + __popc(need & below);
        if (ray >= R.n) {
          done = true;
        } else {
          ox = R.origin[3 * ray];
          oy = R.origin[3 * ray + 1];
          oz = R.origin[3 * ray + 2];
          dx = R.dir[3 * ray];
          dy = R.dir[3 * ray + 1];
          dz = R.dir[3 * ray + 2];
          L = R.length[ray];
          t = R.t0[ray];
          e = R.eps[ray];
          sgn = R.sign != nullptr ? R.sign[ray] : 1.f;
          hit = false;
          steps = 0;
          d_last = FT_BIG;
          d_start = FT_BIG;
          step_taken = 0.f;
          active = L > 0.f && t < L && R.max_steps > 0;
          if (!active) {
            R.hit_out[ray] = 0;
            R.steps_out[ray] = 0;
            if (!R.occlusion) {
              R.t_out[ray] = t;
              R.d_out[ray] = d_last;
            }
          }
        }
      }
    }
    if (!__any_sync(FT_FULL_MASK, active)) break;
    ++iters;
    if (!active) continue;  // the other lanes step; the ballot above waits
    // Per-lane sign: -1 marches inside the solid toward its exit surface.
    const float d = sgn * march_distance(X, none, ox + t * dx, oy + t * dy,
                                         oz + t * dz, hook);
    ++steps;
    ++lane_steps;
    if (relaxed) {
      // as march_kernel: the overstep revert and the budget-crossing rule
      const bool over = step_taken > d_start + d;
      const bool is_hit = !over && d < e;
      const float step_rel = R.omega * d;
      const float step_new = (t + step_rel >= L) ? d : step_rel;
      const float adv = (over || is_hit) ? 0.f : step_new;
      const float t_new = over ? (t - step_taken) + d_start : t + adv;
      const bool still = over || (!is_hit && t_new < L);
      if ((still && !over) || is_hit) d_last = d;
      step_taken = over ? d_start : adv;
      d_start = over ? d_start : d;
      t = t_new;
      hit = hit || is_hit;
      active = still;
    } else {
      const bool is_hit = d < e;
      const float t_new = is_hit ? t : t + d;
      const bool still = !is_hit && t_new < L;
      if (still || is_hit) d_last = d;
      t = t_new;
      hit = hit || is_hit;
      active = still;
    }
    if (!active || steps == R.max_steps) {
      active = false;
      R.hit_out[ray] = hit ? 1 : 0;
      R.steps_out[ray] = steps;
      if (!R.occlusion) {
        R.t_out[ray] = t;
        R.d_out[ray] = d_last;
      }
    }
  }
  if (issued != nullptr && lane == 0) atomicAdd(issued, iters);
  // every lane leaves the loop above together
  const unsigned warp_steps = __reduce_add_sync(FT_FULL_MASK, lane_steps);
  if (evals != nullptr && lane == 0) {
    atomicAdd(evals, (unsigned long long)warp_steps);
  }
}

__global__ void __launch_bounds__(FT_DENSE_THREADS, 1)
march_dense_kernel(DenseRays R, FtProgram P, FtDenseStage S,
                   int* __restrict__ next,
                   unsigned long long* __restrict__ issued,
                   unsigned long long* __restrict__ evals) {
  extern __shared__ __align__(16) unsigned char ft_smem[];
  dense_stage_begin(ft_smem, P, S);
  __syncthreads();  // the threads' own copies, and the barrier's init
  if (S.rows_off >= 0) {
    mbar_wait(smem_addr(ft_smem), 0);
    march_dense_lanes<true>(ft_smem, P, S, R, next, issued, evals);
  } else {
    march_dense_lanes<false>(ft_smem, P, S, R, next, issued, evals);
  }
}

// ---------------------------------------------------------------------------
// K3: the surface pass, slot mode (plans of min/max alone) and AD mode
// (plans with a smooth union)
// ---------------------------------------------------------------------------
//
// Replaces surf_kernel (march_kernel.py:1606) behind the surface
// pallas_call (:2076): surface_eval_slot (:1022; its culled scan
// :1051-1144 and the normal sweep :1231-1269) in slot mode, surface_eval
// (:1304; its culled scan :1359-1456, the sumexp resolve :1520-1528, the
// tree fold ev_g :1530-1565) in AD mode.  At each hit lane's backed-off
// point o + (t - eps) d (SdfObject.fs:73): the unit normal, the material of
// the CSG-visible argmin (ties to the lower slot) and, in slot mode, the
// signed code of the winning leaf (0 on every lane in AD mode).  Slot mode
// folds the scene with DistCode and evaluates the winning leaf's gradient
// once, with dual numbers, on that leaf's row; AD mode folds it with
// DistGrad (a dual evaluation for each min/max group's dense winner and
// each culled pair that wins its group so far, one for every member of a
// sumexp group; expf, not __expf: the weights decide the blend).  Miss
// lanes: normal (0, 0, 1), material -1, code 0.
//
// What bounds it on an H100: bytes, 33 in and 20 out a lane (origin,
// direction, t, epsilon, the hit byte; normal, material, code), against
// the scans of a third of the lanes.  What the design does about the rest:
// - tile-aligned blocks of FT_BLOCK threads stage the program, the dense
//   entries and the tile's candidate-table slices as K1/K2 do (stage_begin;
//   the host's plan, cull.py stage_plan, adds the hit-lane list at its
//   end), so the scan reads shared memory, not dependent __ldg chains; the
//   dense form stages the program, its kind runs, each entry's (material,
//   slot) and the packed rows (dense_stage_begin, cull.py
//   dense_stage_plan);
// - the block compacts its hit lanes: misses write their defaults at once,
//   a block without a hit leaves before it stages anything, and the others
//   list their hit lanes in shared memory (a ballot and a popcount prefix
//   per warp) so that h hits run ceil(h / 32) warps of scans instead of
//   four.  No lane's arithmetic changes: K3 has no warp-collective window,
//   each lane scans its tile's whole list;
// - the candidate scan is specialised by kind (one dispatch per pair, or
//   per run in the dense form), reads rows as 16-byte words and keeps
//   ft_surface_rows rows in flight on separate accumulators, which merge
//   exactly (ft_sdf.cuh scan_rows, scan_run);
// - the winner's gradient comes from its staged row (the dense form: its
//   entry in device memory, one evaluation a lane).
__device__ __forceinline__ void write_normal(float* normal, int i, float gx,
                                             float gy, float gz) {
  const float inv = rsqrtf(gx * gx + gy * gy + gz * gz + 1e-20f);
  normal[3 * i] = gx * inv;
  normal[3 * i + 1] = gy * inv;
  normal[3 * i + 2] = gz * inv;
}

template <typename Ctx>
__device__ __forceinline__ void write_surface(const DistCode& v,
                                              const Ctx& X, int i,
                                              float px, float py, float pz,
                                              float* normal, float* code) {
  float gx = 0.f, gy = 0.f, gz = 0.f;
  if (v.code != 0.f) {
    const Dual g = leaf_dual(X, v.at, px, py, pz);
    const float sgn = v.code < 0.f ? -1.f : 1.f;  // subtract flips the b side
    gx = sgn * g.t[0];
    gy = sgn * g.t[1];
    gz = sgn * g.t[2];
  }
  write_normal(normal, i, gx, gy, gz);
  code[i] = v.code;
}
template <typename Ctx>
__device__ __forceinline__ void write_surface(const DistGrad& v,
                                              const Ctx&, int i, float,
                                              float, float, float* normal,
                                              float* code) {
  write_normal(normal, i, v.x, v.y, v.z);
  code[i] = 0.f;
}

// Occupancy: 128 threads x FT_SURF_BLOCKS blocks an SM.
#define FT_SURF_BLOCKS 7
// the hit-lane list: an int count a warp, then one byte a lane
static_assert(FT_SURF_LIST_BYTES == 4 * (FT_BLOCK / 32) + FT_BLOCK &&
                  FT_SURF_LIST_BYTES % 16 == 0 && FT_BLOCK <= 256,
              "FT_SURF_LIST_BYTES");

// one hit lane's surface at p, folded over what the block staged
template <typename V, typename Ctx>
__device__ __forceinline__ void surface_lane(const Ctx& X, int li, float e,
                                             float px, float py, float pz,
                                             float* __restrict__ normal,
                                             int* __restrict__ midx_out,
                                             float* __restrict__ code_out) {
  MaterialArgmin material;
  const V v = surface_scene<V>(X, e, px, py, pz, material);
  write_surface(v, X, li, px, py, pz, normal, code_out);
  midx_out[li] = material.mat;
}

// Stage = FtStage: the culled form (C its tables); FtDenseStage: the
// dense form (C null), which stages the program, its runs, each entry's
// (material, slot) and the packed rows (dense_stage_begin)
template <typename V, typename Stage>
__device__ __forceinline__ void surface_block(
    const float* __restrict__ origin, const float* __restrict__ dir,
    const float* __restrict__ tt, const float* __restrict__ eps,
    const unsigned char* __restrict__ hitm, int n, const FtProgram& P,
    const FtCull* C, const Stage& S, float* __restrict__ normal,
    int* __restrict__ midx_out, float* __restrict__ code_out) {
  constexpr bool dense = std::is_same<Stage, FtDenseStage>::value;
  extern __shared__ __align__(16) unsigned char ft_smem[];
  const int i = blockIdx.x * FT_BLOCK + threadIdx.x;
  const int tile = blockIdx.x / (FT_TILE / FT_BLOCK);
  const bool hit = i < n && hitm[i] != 0;
  if (i < n && !hit) {
    normal[3 * i] = 0.f;
    normal[3 * i + 1] = 0.f;
    normal[3 * i + 2] = 1.f;
    midx_out[i] = -1;
    code_out[i] = 0.f;
  }
  if (!__syncthreads_or(hit)) return;
  int* counts = (int*)(ft_smem + S.bytes - FT_SURF_LIST_BYTES);
  unsigned char* list = (unsigned char*)(counts + FT_BLOCK / 32);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned ball = __ballot_sync(FT_FULL_MASK, hit);
  if (lane == 0) counts[warp] = __popc(ball);
  if constexpr (dense) {
    dense_stage_begin(ft_smem, P, S);
  } else {
    stage_begin(ft_smem, P, *C, S, tile);
  }
  __syncthreads();  // the counts, the threads' copies, the barrier's init
  int before = 0, hits = 0;
#pragma unroll
  for (int w = 0; w < FT_BLOCK / 32; ++w) {
    before += w < warp ? counts[w] : 0;
    hits += counts[w];
  }
  if (hit) list[before + __popc(ball & ((1u << lane) - 1u))] = threadIdx.x;
  __syncthreads();
  if (threadIdx.x >= hits) return;
  // thread j scans the block's j-th hit lane; its loads overlap the copies
  const int li = blockIdx.x * FT_BLOCK + list[threadIdx.x];
  const float e = eps[li];
  const float ts = tt[li] - e;
  const float px = origin[3 * li] + ts * dir[3 * li];
  const float py = origin[3 * li + 1] + ts * dir[3 * li + 1];
  const float pz = origin[3 * li + 2] + ts * dir[3 * li + 2];
  if constexpr (dense) {
    if (S.rows_off >= 0) {
      mbar_wait(smem_addr(ft_smem), 0);
      surface_lane<V>(dense_ctx<true>(ft_smem, P, S), li, e, px, py, pz,
                      normal, midx_out, code_out);
    } else {
      surface_lane<V>(dense_ctx<false>(ft_smem, P, S), li, e, px, py, pz,
                      normal, midx_out, code_out);
    }
  } else {
    if (S.bulk_bytes > 0) mbar_wait(smem_addr(ft_smem), 0);
    const MarchCtx X = {P, S, ft_smem, C->early_out};
    surface_lane<V>(X, li, e, px, py, pz, normal, midx_out, code_out);
  }
}

__global__ void __launch_bounds__(FT_BLOCK, FT_SURF_BLOCKS)
surface_kernel(const float* __restrict__ origin, const float* __restrict__ dir,
               const float* __restrict__ tt, const float* __restrict__ eps,
               const unsigned char* __restrict__ hitm, int n, FtProgram P,
               FtCull C, FtStage S, float* __restrict__ normal,
               int* __restrict__ midx_out, float* __restrict__ code_out) {
  surface_block<DistCode>(origin, dir, tt, eps, hitm, n, P, &C, S, normal,
                          midx_out, code_out);
}

__global__ void __launch_bounds__(FT_BLOCK, FT_SURF_BLOCKS)
surface_ad_kernel(const float* __restrict__ origin,
                  const float* __restrict__ dir, const float* __restrict__ tt,
                  const float* __restrict__ eps,
                  const unsigned char* __restrict__ hitm, int n, FtProgram P,
                  FtCull C, FtStage S, float* __restrict__ normal,
                  int* __restrict__ midx_out, float* __restrict__ code_out) {
  surface_block<DistGrad>(origin, dir, tt, eps, hitm, n, P, &C, S, normal,
                          midx_out, code_out);
}

// the dense form of both modes: the same blocks over the packed rows
__global__ void __launch_bounds__(FT_BLOCK, FT_SURF_BLOCKS)
surface_dense_kernel(const float* __restrict__ origin,
                     const float* __restrict__ dir,
                     const float* __restrict__ tt,
                     const float* __restrict__ eps,
                     const unsigned char* __restrict__ hitm, int n,
                     FtProgram P, FtDenseStage S, float* __restrict__ normal,
                     int* __restrict__ midx_out, float* __restrict__ code_out) {
  surface_block<DistCode>(origin, dir, tt, eps, hitm, n, P, nullptr, S,
                          normal, midx_out, code_out);
}

__global__ void __launch_bounds__(FT_BLOCK, FT_SURF_BLOCKS)
surface_ad_dense_kernel(const float* __restrict__ origin,
                        const float* __restrict__ dir,
                        const float* __restrict__ tt,
                        const float* __restrict__ eps,
                        const unsigned char* __restrict__ hitm, int n,
                        FtProgram P, FtDenseStage S,
                        float* __restrict__ normal,
                        int* __restrict__ midx_out,
                        float* __restrict__ code_out) {
  surface_block<DistGrad>(origin, dir, tt, eps, hitm, n, P, nullptr, S,
                          normal, midx_out, code_out);
}

// ---------------------------------------------------------------------------
// C entry points (bound with ctypes by ops/cuda/march_kernel.py)
// ---------------------------------------------------------------------------

static inline int blocks_for(int n, int threads) {
  return (n + threads - 1) / threads;
}

// Dynamic shared memory above 48 KB needs the opt-in; a refusal is the
// launch's error.
template <typename Hook>
static int launch_march(const float* origin, const float* dir,
                        const float* length, const float* eps,
                        const float* t0, const float* sign, int n,
                        const FtProgram* prog, const FtCull* cull,
                        const FtStage* stage, int max_steps, float omega,
                        int occlusion, float* t_out, int* hit_out,
                        float* d_out, int* steps_out,
                        unsigned long long* sections, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (stage->bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        march_kernel<Hook>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        stage->bytes);
    if (err != cudaSuccess) return (int)err;
  }
  march_kernel<Hook><<<blocks_for(n, FT_BLOCK), FT_BLOCK, stage->bytes,
                       (cudaStream_t)stream>>>(
      origin, dir, length, eps, t0, sign, n, *prog, *cull, *stage, max_steps,
      omega, occlusion, t_out, hit_out, d_out, steps_out, sections);
  return (int)cudaGetLastError();
}

extern "C" int ft_march(const float* origin, const float* dir,
                        const float* length, const float* eps, const float* t0,
                        const float* sign, int n, const FtProgram* prog,
                        const FtCull* cull, const FtStage* stage,
                        int max_steps, float omega, int occlusion,
                        float* t_out, int* hit_out, float* d_out,
                        int* steps_out, void* stream) {
  return launch_march<NoPrimHook>(origin, dir, length, eps, t0, sign, n, prog,
                                  cull, stage, max_steps, omega, occlusion,
                                  t_out, hit_out, d_out, steps_out, nullptr,
                                  stream);
}

// The dense form: a persistent grid of blocks of `threads` (whole warps,
// at most FT_DENSE_THREADS), as many as fit the card at once (no more than
// the rays need), the ray counter zeroed on the launch's stream first;
// the blocks an SM go to *blocks_per_sm (or nowhere).
extern "C" int ft_march_dense(const float* origin, const float* dir,
                              const float* length, const float* eps,
                              const float* t0, const float* sign, int n,
                              const FtProgram* prog,
                              const FtDenseStage* stage, int threads,
                              int max_steps, float omega, int occlusion,
                              float* t_out, int* hit_out, float* d_out,
                              int* steps_out, int* next,
                              unsigned long long* issued,
                              unsigned long long* evals, int* blocks_per_sm,
                              void* stream) {
  if (threads <= 0 || threads % 32 != 0 || threads > FT_DENSE_THREADS) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return (int)cudaGetLastError();
  cudaError_t err;
  if (stage->bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(march_dense_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               stage->bytes);
    if (err != cudaSuccess) return (int)err;
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, march_dense_kernel, threads, stage->bytes);
  if (err != cudaSuccess) return (int)err;
  if (blocks_per_sm != nullptr) *blocks_per_sm = per_sm;
  const int grid = std::min(std::max(per_sm, 1) * sms,
                            blocks_for(n, threads));
  err = cudaMemsetAsync(next, 0, sizeof(int), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const DenseRays R = {origin, dir, length, eps, t0, sign, t_out, hit_out,
                       d_out, steps_out, n, max_steps, occlusion, omega};
  march_dense_kernel<<<grid, threads, stage->bytes,
                       (cudaStream_t)stream>>>(R, *prog, *stage, next,
                                               issued, evals);
  return (int)cudaGetLastError();
}

// The instrumented twin: the same kernel with SectionHook, adding each
// warp's clock64() deltas per section and its counts to
// sections[SEC_N + CNT_N].  A diagnostic: slower than the kernel (the
// clock reads and about 20 more registers), launched by no path of the
// renderer.
extern "C" int ft_march_sections(
    const float* origin, const float* dir, const float* length,
    const float* eps, const float* t0, const float* sign, int n,
    const FtProgram* prog, const FtCull* cull, const FtStage* stage,
    int max_steps, float omega, int occlusion, float* t_out, int* hit_out,
    float* d_out, int* steps_out, unsigned long long* sections,
    void* stream) {
  return launch_march<SectionHook>(origin, dir, length, eps, t0, sign, n,
                                   prog, cull, stage, max_steps, omega,
                                   occlusion, t_out, hit_out, d_out,
                                   steps_out, sections, stream);
}

// Dynamic shared memory above 48 KB needs the opt-in (as launch_march).
typedef void (*SurfaceKernel)(const float*, const float*, const float*,
                              const float*, const unsigned char*, int,
                              FtProgram, FtCull, FtStage, float*, int*,
                              float*);
static int launch_surface(SurfaceKernel kernel, const float* origin,
                          const float* dir, const float* t, const float* eps,
                          const unsigned char* hit, int n,
                          const FtProgram* prog, const FtCull* cull,
                          const FtStage* stage, float* normal, int* midx,
                          float* code, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (stage->bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, stage->bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks_for(n, FT_BLOCK), FT_BLOCK, stage->bytes,
           (cudaStream_t)stream>>>(origin, dir, t, eps, hit, n, *prog, *cull,
                                   *stage, normal, midx, code);
  return (int)cudaGetLastError();
}

extern "C" int ft_surface(const float* origin, const float* dir,
                          const float* t, const float* eps,
                          const unsigned char* hit, int n,
                          const FtProgram* prog, const FtCull* cull,
                          const FtStage* stage, float* normal, int* midx,
                          float* code, void* stream) {
  return launch_surface(surface_kernel, origin, dir, t, eps, hit, n, prog,
                        cull, stage, normal, midx, code, stream);
}

extern "C" int ft_surface_ad(const float* origin, const float* dir,
                             const float* t, const float* eps,
                             const unsigned char* hit, int n,
                             const FtProgram* prog, const FtCull* cull,
                             const FtStage* stage, float* normal, int* midx,
                             float* code, void* stream) {
  return launch_surface(surface_ad_kernel, origin, dir, t, eps, hit, n, prog,
                        cull, stage, normal, midx, code, stream);
}

typedef void (*SurfaceDenseKernel)(const float*, const float*, const float*,
                                   const float*, const unsigned char*, int,
                                   FtProgram, FtDenseStage, float*, int*,
                                   float*);
static int launch_surface_dense(SurfaceDenseKernel kernel,
                                const float* origin, const float* dir,
                                const float* t, const float* eps,
                                const unsigned char* hit, int n,
                                const FtProgram* prog,
                                const FtDenseStage* stage, float* normal,
                                int* midx, float* code, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (stage->bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, stage->bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks_for(n, FT_BLOCK), FT_BLOCK, stage->bytes,
           (cudaStream_t)stream>>>(origin, dir, t, eps, hit, n, *prog,
                                   *stage, normal, midx, code);
  return (int)cudaGetLastError();
}

extern "C" int ft_surface_dense(const float* origin, const float* dir,
                                const float* t, const float* eps,
                                const unsigned char* hit, int n,
                                const FtProgram* prog,
                                const FtDenseStage* stage, float* normal,
                                int* midx, float* code, void* stream) {
  return launch_surface_dense(surface_dense_kernel, origin, dir, t, eps, hit,
                              n, prog, stage, normal, midx, code, stream);
}

extern "C" int ft_surface_ad_dense(const float* origin, const float* dir,
                                   const float* t, const float* eps,
                                   const unsigned char* hit, int n,
                                   const FtProgram* prog,
                                   const FtDenseStage* stage, float* normal,
                                   int* midx, float* code, void* stream) {
  return launch_surface_dense(surface_ad_dense_kernel, origin, dir, t, eps,
                              hit, n, prog, stage, normal, midx, code,
                              stream);
}

extern "C" const char* ft_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

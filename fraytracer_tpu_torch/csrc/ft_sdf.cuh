// Shared device code of the march and surface kernels: the flattened
// scene program, the seven primitive distance functions (written once,
// templated over the scalar type: float for marching, a 3-component
// forward-mode dual number for exact gradients), the stack values of the
// scene program, and its two folds over what a block staged: the march's
// (windowed candidate passes) and the surface pass's (whole-list scans),
// each also over the dense form's kind runs.
//
// The formulas are those of fraytracer_tpu_torch/ops/sdf.py (the plain
// PyTorch versions the kernels are held against), which are algebraically
// the same as the TPU kernel's _d_*_gen functions.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FT_BIG 3.0e38f
#define FT_PSTRIDE 10    // floats per primitive row (widest kind: triangle)
#define FT_MAX_STACK 16  // CSG value-stack depth; the host checks plans
// culled tables (ops/cuda/cull.py: TILE, CAND_UNROLL, PSTRIDE + 2, MAX_PAIRS)
#define FT_TILE 1024       // rays per candidate table
#define FT_CAND_UNROLL 8   // table rows per window chunk
#define FT_TABLE_W 12      // floats per table row: params, material, slot
#define FT_MAX_PAIRS 8     // culled (group, kind) pairs per launch
#define FT_BLOCK 128       // threads of a K1/K2/K3 block: FT_TILE / 8, so
                           // a block reads one tile's tables
#define FT_SURF_LIST_BYTES 144  // K3's hit-lane list after the staged plan:
                                // FT_BLOCK / 32 warp counts, FT_BLOCK lanes
#define FT_DENSE_THREADS 768  // the dense K1/K2's threads an SM: six warps a
                              // scheduler under its register budget; a
                              // block of up to as many (ops/cuda/cull.py
                              // dense_march_threads)
#define FT_FULL_MASK 0xffffffffu

// primitive kinds, in the flattener's KINDS order
enum { K_SPHERE = 0, K_CAPSULE, K_TORUS, K_TRIANGLE, K_BOX, K_CONE, K_PLANE };
// postfix tree opcodes
enum { OP_GROUP = 0, OP_UNION, OP_INTERSECT, OP_SUBTRACT, OP_SMOOTH };
// group reductions
enum { G_MIN = 0, G_MAX, G_SUMEXP };

// The scene lowered to a small program (built by ops/cuda/march_kernel.py,
// mirrored there as a ctypes Structure — keep the field order in step).
// Entries are the primitives ordered by group, members of a group in
// ascending global slot; each group is one contiguous entry range.  The
// rows of culled pairs come after every group's range: their group reads
// them from the per-tile candidate tables (FtCull).  Slots are kind-major,
// so a group's range is a few runs of one kind (at most one a kind): the
// dense form reads its entries run by run from `packed`, each row at its
// kind's width rounded up to 16 bytes (ft_kind_width), one dispatch a run.
struct FtProgram {
  const int* ops;           // [n_ops * 2] (opcode, arg): arg = group id or
                            // operand count
  const float* op_k;        // [n_ops] smooth-union strength
  int n_ops;
  const int* groups;        // [n_groups * 3] (entry start, entry end, op)
  const float* group_k;     // [n_groups]
  int n_groups;
  const int* ent_kind;      // [n_ent]
  const int* ent_slot;      // [n_ent] global slot
  const int* ent_mat;       // [n_ent] CSG-visible material, -1 = none
  const float* ent_params;  // [n_ent * FT_PSTRIDE]; torus axes unit length
  int n_ent;
  const int* group_pairs;   // [n_groups * 2] the group's pairs [start, end)
  const int* runs;          // [n_runs * 4] (first entry, end, kind, first
                            // 16-byte word of the run in packed)
  int n_runs;
  const int* group_runs;    // [n_groups * 2] the group's runs [start, end)
  const float* packed;      // the dense entries' rows, run after run
  const int* ent_ms;        // [n_ent * 2] (CSG-visible material, slot)
};

// One culled (group, kind) pair: per-tile tables built on the host
// (ops/cuda/cull.py build_pair_tables), G = number of ray tiles.
struct FtPair {
  const float* table;  // [G, m, FT_TABLE_W] candidates, ascending axial key
  const float* keys;   // [G, 2, m / FT_CAND_UNROLL] chunk max(a+r), min(a-r)
  const float* misc;   // [G, 4] count, cos_lo, window clamp, surface margin
  const float* hsuf;   // [G, m / FT_CAND_UNROLL] suffix-min of a-r per chunk
  int m;               // table rows per tile (whole chunks)
  int kind;            // primitive kind of every row
  int group_size;      // the pair's rows (count < group_size: cone-excluded)
  int pad_;
};

// What a launch reads besides rays and program; n_pairs == 0 is the dense
// form.
struct FtCull {
  const float* oa;  // [n] (origin - apex) . axis of the lane's tile cone
  const float* ca;  // [n] direction . axis
  int n_pairs;
  int early_out;    // running-min early-out of min-group windows
  FtPair pairs[FT_MAX_PAIRS];
};

// The shared-memory plan of one K1/K2/K3 launch, sized on the host from
// the program's and the tables' shapes alone (ops/cuda/cull.py stage_plan;
// a block may use 227 KB; K3's plan ends with its FT_SURF_LIST_BYTES).
// Offsets are bytes from the block's dynamic shared memory; it starts with
// the copy barrier (16 bytes) and the per-pair records (FT_MAX_PAIRS x 48
// bytes); the program is always staged, one 32-byte record an op (SOp).  A
// staged pair holds the tile's table slice [m, FT_TABLE_W], its keys [2, m
// / 8] and its hsuf [m / 8], each at a multiple of 16 bytes; pairs are
// staged in program order while they fit, the others are read from device
// memory.
struct FtStage {
  int bytes;        // dynamic shared memory of a block
  int bulk_bytes;   // bytes the bulk copies bring in (0: no barrier)
  int ents;         // dense entries staged as rows of FT_TABLE_W floats
                    // (parameters, kind bits at FT_PSTRIDE); 0: none
  int ops_off, ents_off;
  int bulk_keys;    // bit q: pair q's keys slice goes by bulk copy
  int bulk_hsuf;    // bit q: pair q's hsuf slice goes by bulk copy
  int pair_off[FT_MAX_PAIRS];  // pair q's slices, -1: not staged
};

// The shared-memory plan of a dense-form launch (K1/K2
// march_dense_kernel, K3's dense kernels), sized on the host from shapes
// alone (ops/cuda/cull.py dense_stage_plan).  Byte offsets from the block's
// dynamic shared memory, which starts with the copy barrier (16 bytes):
// the program (one SOp an op), the runs (one int4 a run), K3's (material,
// slot) pairs (one int2 an entry) and the packed rows (one bulk copy), the
// last two while they fit, else read from device memory; K3's hit-lane
// list at the end.
struct FtDenseStage {
  int bytes;        // dynamic shared memory of a block
  int ops_off, runs_off;
  int ms_off;       // -1: (material, slot) from device memory (ent_ms)
  int rows_off;     // -1: the packed rows from device memory
  int rows_bytes;   // bytes of the packed rows, a multiple of 16
};

// The table build (csrc/cull.cu, ops/cuda/cull_kernel.py): a tile's cone
// and its FT_SUBF sub-tiles' cones, FT_CONE_W floats each (the fields of
// ops/cuda/cull.py TileCones in its order, `any_active` as 0/1, one float
// of padding), then one select block a (tile, pair).
#define FT_SUBF 4          // sub-tiles whose candidacy masks are OR-ed
#define FT_CONES 5         // cones a tile: its own, then its sub-tiles'
#define FT_CONE_W 20       // floats of one cone's statistics
#define FT_SEL_THREADS 256 // threads of a select block

// One culled pair of a table build: its members' raw rows in, the
// PairTable fields out (each [G, ...] of the launch's G tiles).
struct FtBuildPair {
  const float* params;  // [g, width] the pair's parameter rows
  const float* ids;     // [g, 2] CSG-visible material, global slot
  int64_t* idx;         // [G, m] candidate rows relative to the first
  int* count;           // [G] true candidate count
  float* table;         // [G, m, FT_TABLE_W]
  float* keys;          // [G, 2, m / FT_CAND_UNROLL] chunk lo_c, hi_c
  float* misc;          // [G, 4] count, cos_lo, window clamp, margin
  float* hsuf;          // [G, m / FT_CAND_UNROLL] suffix minima
  float* scratch;       // [G, scratch_words] the large path's buffers;
                        // null: shared memory
  int kind, width, g, m;
  float reach;          // blend reach k of the group (0: none)
  int scratch_words;    // 4-byte words of one block's buffers
};

// A site's select launch: every pair of the site, grid (G, n_pairs).
struct FtBuild {
  const float* cones;          // [G, FT_CONES, FT_CONE_W]
  uint8_t* overflow;           // bool flag: a count > m (null: impossible)
  float window_clamp;
  int converging;              // point-light cone (two-sided tangents)
  int n_pairs;
  int pad_;
  FtBuildPair pairs[FT_MAX_PAIRS];
};

// A lane as the culled passes see it.  K1/K2 call the scene with every
// lane of a warp (inactive ones included): the window is warp-collective.
struct Lane {
  float oa, ca;   // axial origin offset and direction cosine
  float t, eps;   // ray parameter of this step, hit threshold
  bool active;    // takes part in the window statistics
};

// ---------------------------------------------------------------------------
// forward-mode dual number of N tangents over a scalar S (float, or a Jet:
// nested, for mixed second derivatives).  Dual, a float and its gradient
// w.r.t. the query point, is K3's; the leaf backward (leaf_vjp.cu) seeds
// the parameters of a row (SeedRow) and a direction of the query point,
// and a Jet over a Jet carries a second direction of the query point.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float val(float a) { return a; }
__device__ __forceinline__ float sqrt_(float a) { return sqrtf(a); }

template <typename S, int N>
struct Jet {
  S v;
  S t[N];
};

template <typename S, int N>
__device__ __forceinline__ float val(const Jet<S, N>& a) { return val(a.v); }

// Jet op Jet
template <typename S, int N>
__device__ __forceinline__ Jet<S, N> operator+(const Jet<S, N>& a,
                                               const Jet<S, N>& b) {
  Jet<S, N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] + b.t[i];
  return r;
}
template <typename S, int N>
__device__ __forceinline__ Jet<S, N> operator-(const Jet<S, N>& a,
                                               const Jet<S, N>& b) {
  Jet<S, N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] - b.t[i];
  return r;
}
template <typename S, int N>
__device__ __forceinline__ Jet<S, N> operator-(const Jet<S, N>& a) {
  Jet<S, N> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = -a.t[i];
  return r;
}
template <typename S, int N>
__device__ __forceinline__ Jet<S, N> operator*(const Jet<S, N>& a,
                                               const Jet<S, N>& b) {
  Jet<S, N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] * b.v + a.v * b.t[i];
  return r;
}
template <typename S, int N>
__device__ __forceinline__ Jet<S, N> operator/(const Jet<S, N>& a,
                                               const Jet<S, N>& b) {
  const S inv = 1.f / b.v;
  const S q = a.v / b.v;
  Jet<S, N> r;
  r.v = q;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = (a.t[i] - q * b.t[i]) * inv;
  return r;
}

// a Jet and a constant of its scalar type (for S = float: a float)
template <typename S, int N>
__device__ __forceinline__ Jet<S, N> operator+(const Jet<S, N>& a,
                                               const S& b) {
  Jet<S, N> r = a;
  r.v = a.v + b;
  return r;
}
template <typename S, int N>
__device__ __forceinline__ Jet<S, N> operator+(const S& a,
                                               const Jet<S, N>& b) {
  return b + a;
}
template <typename S, int N>
__device__ __forceinline__ Jet<S, N> operator-(const Jet<S, N>& a,
                                               const S& b) {
  Jet<S, N> r = a;
  r.v = a.v - b;
  return r;
}
template <typename S, int N>
__device__ __forceinline__ Jet<S, N> operator-(const S& a,
                                               const Jet<S, N>& b) {
  Jet<S, N> r = -b;
  r.v = a - b.v;
  return r;
}
template <typename S, int N>
__device__ __forceinline__ Jet<S, N> operator*(const Jet<S, N>& a,
                                               const S& b) {
  Jet<S, N> r;
  r.v = a.v * b;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] * b;
  return r;
}
template <typename S, int N>
__device__ __forceinline__ Jet<S, N> operator*(const S& a,
                                               const Jet<S, N>& b) {
  return b * a;
}
template <typename S, int N>
__device__ __forceinline__ Jet<S, N> operator/(const Jet<S, N>& a,
                                               const S& b) {
  Jet<S, N> r;
  r.v = a.v / b;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] / b;
  return r;
}
template <typename S, int N>
__device__ __forceinline__ Jet<S, N> operator/(const S& a,
                                               const Jet<S, N>& b) {
  const S inv = 1.f / b.v;
  const S q = a / b.v;
  Jet<S, N> r;
  r.v = q;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = -(q * b.t[i]) * inv;
  return r;
}

// a nested Jet and a float constant
template <typename S, int M, int N>
__device__ __forceinline__ Jet<Jet<S, M>, N> operator+(
    const Jet<Jet<S, M>, N>& a, float b) {
  Jet<Jet<S, M>, N> r = a;
  r.v = a.v + b;
  return r;
}
template <typename S, int M, int N>
__device__ __forceinline__ Jet<Jet<S, M>, N> operator+(
    float a, const Jet<Jet<S, M>, N>& b) {
  return b + a;
}
template <typename S, int M, int N>
__device__ __forceinline__ Jet<Jet<S, M>, N> operator-(
    const Jet<Jet<S, M>, N>& a, float b) {
  Jet<Jet<S, M>, N> r = a;
  r.v = a.v - b;
  return r;
}
template <typename S, int M, int N>
__device__ __forceinline__ Jet<Jet<S, M>, N> operator-(
    float a, const Jet<Jet<S, M>, N>& b) {
  Jet<Jet<S, M>, N> r = -b;
  r.v = a - b.v;
  return r;
}
template <typename S, int M, int N>
__device__ __forceinline__ Jet<Jet<S, M>, N> operator*(
    const Jet<Jet<S, M>, N>& a, float b) {
  Jet<Jet<S, M>, N> r;
  r.v = a.v * b;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] * b;
  return r;
}
template <typename S, int M, int N>
__device__ __forceinline__ Jet<Jet<S, M>, N> operator*(
    float a, const Jet<Jet<S, M>, N>& b) {
  return b * a;
}
template <typename S, int M, int N>
__device__ __forceinline__ Jet<Jet<S, M>, N> operator/(
    const Jet<Jet<S, M>, N>& a, float b) {
  Jet<Jet<S, M>, N> r;
  r.v = a.v / b;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] / b;
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Jet<S, N> sqrt_(const Jet<S, N>& a) {
  const S s = sqrt_(a.v);
  const S h = 0.5f / s;
  Jet<S, N> r;
  r.v = s;
#pragma unroll
  for (int i = 0; i < N; ++i) r.t[i] = a.t[i] * h;
  return r;
}

using Dual = Jet<float, 3>;  // value, then d/dx, d/dy, d/dz
template <typename T>
__device__ __forceinline__ T max_(T a, T b) { return val(a) >= val(b) ? a : b; }
template <typename T>
__device__ __forceinline__ T min_(T a, T b) { return val(a) <= val(b) ? a : b; }
__device__ __forceinline__ float max_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ float min_(float a, float b) { return fminf(a, b); }
// constant promoted to the scalar type of the second argument
__device__ __forceinline__ float dual_or(float c, float) { return c; }
template <typename S, int N>
__device__ __forceinline__ Jet<S, N> dual_or(float c, const Jet<S, N>&) {
  Jet<S, N> r{};
  r.v = dual_or(c, r.v);
  return r;
}
template <typename T>
__device__ __forceinline__ T cmax(T a, float b) {
  return val(a) >= b ? a : dual_or(b, a);
}
template <typename T>
__device__ __forceinline__ T cmin(T a, float b) {
  return val(a) <= b ? a : dual_or(b, a);
}
template <typename T>
__device__ __forceinline__ T clamp01(T a) { return cmin(cmax(a, 0.f), 1.f); }
// max with a float floor of a row-only quantity (float, or a Jet where the
// row's parameters carry tangents)
__device__ __forceinline__ float pmax(float a, float b) { return fmaxf(a, b); }
template <typename S, int N>
__device__ __forceinline__ Jet<S, N> pmax(const Jet<S, N>& a, float b) {
  return cmax(a, b);
}
template <typename T>
__device__ __forceinline__ T abs_(T a) { return val(a) < 0.f ? -a : a; }
template <typename T>
__device__ __forceinline__ float sign_(T a) {
  float v = val(a);
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

// A primitive row as the distance functions read it.  GRow: device memory
// through the read-only cache, exact (IEEE) square roots — a culled
// launch's dense entries in K1/K2 when there are more than the block
// stages.  RRow: a row held in registers (loaded as 16-byte words from
// shared or device memory); FAST takes sqrt.approx for the march distance
// (K1/K2 only: a step length, held against the plain version at
// t <= 1e-4), K3 keeps exact roots.
struct GRow {
  const float* p;
  static constexpr bool fast = false;
  __device__ __forceinline__ float operator[](int j) const {
    return __ldg(p + j);
  }
};
template <bool FAST>
struct RRow {
  float v[FT_TABLE_W];
  static constexpr bool fast = FAST;
  __device__ __forceinline__ float operator[](int j) const { return v[j]; }
};
// the first WORDS 16-byte words of the row at r4 into registers
template <int WORDS, bool FAST>
__device__ __forceinline__ RRow<FAST> load_row(const float4* r4) {
  RRow<FAST> r;
#pragma unroll
  for (int w = 0; w < WORDS; ++w) {
    const float4 x = r4[w];
    r.v[4 * w] = x.x;
    r.v[4 * w + 1] = x.y;
    r.v[4 * w + 2] = x.z;
    r.v[4 * w + 3] = x.w;
  }
  return r;
}
// floats of a row that a kind's distance reads (scene/flatten.py
// PARAM_WIDTH)
__host__ __device__ constexpr int ft_kind_width(int kind) {
  return kind == K_SPHERE || kind == K_PLANE ? 4
         : kind == K_CAPSULE || kind == K_BOX ? 7
         : kind == K_TRIANGLE ? 10 : 8;
}
// the j-th parameter of a row: a float, or a Jet for a SeedRow
template <typename G>
__device__ __forceinline__ auto ld(const G& g, int j) {
  return g[j];
}
template <typename G>
__device__ __forceinline__ float root(float a) {
  if constexpr (G::fast) {
    float r;
    asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(a));
    return r;
  } else {
    return sqrtf(a);
  }
}
template <typename G, typename S, int N>
__device__ __forceinline__ Jet<S, N> root(const Jet<S, N>& a) {
  return sqrt_(a);
}

// A row in device memory whose parameters are the first P of N Jet
// tangents (the leaf backward: derivatives w.r.t. the row as read).
template <int N>
struct SeedRow {
  const float* p;
  static constexpr bool fast = false;
  __device__ __forceinline__ Jet<float, N> operator[](int j) const {
    Jet<float, N> r{};
    r.v = __ldg(p + j);
    r.t[j] = 1.f;
    return r;
  }
};

// ---------------------------------------------------------------------------
// the seven distance functions (ops/sdf.py formulas)
// ---------------------------------------------------------------------------
//
// T: the query point's scalar type; a row-only quantity has the type of
// ld(g, j) (a float, or a Jet with parameter tangents).

template <typename T, typename G>
__device__ __forceinline__ T d_sphere(const G& g, T px, T py, T pz) {
  T dx = px - ld(g, 0), dy = py - ld(g, 1), dz = pz - ld(g, 2);
  return root<G>(dx * dx + dy * dy + dz * dz + 1e-20f) - ld(g, 3);
}

template <typename T, typename G>
__device__ __forceinline__ T d_capsule(const G& g, T px, T py, T pz) {
  const auto ax = ld(g, 0), ay = ld(g, 1), az = ld(g, 2);
  const auto bax = ld(g, 3) - ax, bay = ld(g, 4) - ay, baz = ld(g, 5) - az;
  T pax = px - ax, pay = py - ay, paz = pz - az;
  const auto denom = pmax(bax * bax + bay * bay + baz * baz, 1e-20f);
  T h = clamp01((pax * bax + pay * bay + paz * baz) / denom);
  T ex = pax - h * bax, ey = pay - h * bay, ez = paz - h * baz;
  return root<G>(ex * ex + ey * ey + ez * ez + 1e-20f) - ld(g, 6);
}

template <typename T, typename G>
__device__ __forceinline__ T d_torus(const G& g, T px, T py, T pz) {
  // axis (g[3..5]) is normalized host-side with the plain version's formula
  const auto nx = ld(g, 3), ny = ld(g, 4), nz = ld(g, 5);
  T qx = px - ld(g, 0), qy = py - ld(g, 1), qz = pz - ld(g, 2);
  T h = qx * nx + qy * ny + qz * nz;
  T wx = qx - h * nx, wy = qy - h * ny, wz = qz - h * nz;
  T radial = root<G>(wx * wx + wy * wy + wz * wz + 1e-20f) - ld(g, 6);
  return root<G>(h * h + radial * radial + 1e-20f) - ld(g, 7);
}

template <typename T, typename P>
__device__ __forceinline__ T edge_d2(P ex, P ey, P ez, T qx, T qy, T qz) {
  const P denom = pmax(ex * ex + ey * ey + ez * ez, 1e-20f);
  T h = clamp01((qx * ex + qy * ey + qz * ez) / denom);
  T ux = qx - h * ex, uy = qy - h * ey, uz = qz - h * ez;
  return ux * ux + uy * uy + uz * uz;
}

template <typename T, typename G>
__device__ __forceinline__ T d_triangle(const G& g, T px, T py, T pz) {
  const auto v1x = ld(g, 0), v1y = ld(g, 1), v1z = ld(g, 2);
  const auto v2x = ld(g, 3), v2y = ld(g, 4), v2z = ld(g, 5);
  const auto v3x = ld(g, 6), v3y = ld(g, 7), v3z = ld(g, 8);
  const auto ax = v2x - v1x, ay = v2y - v1y, az = v2z - v1z;  // v21
  const auto bx = v3x - v2x, by = v3y - v2y, bz = v3z - v2z;  // v32
  const auto cx = v1x - v3x, cy = v1y - v3y, cz = v1z - v3z;  // v13
  // nor = cross(v21, v13)
  const auto nx = ay * cz - az * cy, ny = az * cx - ax * cz,
             nz = ax * cy - ay * cx;
  T p1x = px - v1x, p1y = py - v1y, p1z = pz - v1z;
  T p2x = px - v2x, p2y = py - v2y, p2z = pz - v2z;
  T p3x = px - v3x, p3y = py - v3y, p3z = pz - v3z;
  T d2e = min_(edge_d2(ax, ay, az, p1x, p1y, p1z),
               min_(edge_d2(bx, by, bz, p2x, p2y, p2z),
                    edge_d2(cx, cy, cz, p3x, p3y, p3z)));
  // inside test: signs of the edge half-planes, cross(edge, nor) · p_i
  float s = sign_((ay * nz - az * ny) * p1x + (az * nx - ax * nz) * p1y +
                  (ax * ny - ay * nx) * p1z) +
            sign_((by * nz - bz * ny) * p2x + (bz * nx - bx * nz) * p2y +
                  (bx * ny - by * nx) * p2z) +
            sign_((cy * nz - cz * ny) * p3x + (cz * nx - cx * nz) * p3y +
                  (cx * ny - cy * nx) * p3z);
  const auto nor2 = pmax(nx * nx + ny * ny + nz * nz, 1e-20f);
  T h = nx * p1x + ny * p1y + nz * p1z;
  T d2f = h * h / nor2;
  return root<G>((s >= 2.f ? d2f : d2e) + 1e-20f) - ld(g, 9);
}

template <typename T, typename G>
__device__ __forceinline__ T d_box(const G& g, T px, T py, T pz) {
  T qx = abs_(px - ld(g, 0)) - ld(g, 3);
  T qy = abs_(py - ld(g, 1)) - ld(g, 4);
  T qz = abs_(pz - ld(g, 2)) - ld(g, 5);
  T ox = cmax(qx, 0.f), oy = cmax(qy, 0.f), oz = cmax(qz, 0.f);
  T outside = root<G>(ox * ox + oy * oy + oz * oz + 1e-20f);
  T inside = cmin(max_(max_(qx, qy), qz), 0.f);
  return outside + inside - ld(g, 6);
}

template <typename T, typename G>
__device__ __forceinline__ T d_cone(const G& g, T px, T py, T pz) {
  const auto ax = ld(g, 0), ay = ld(g, 1), az = ld(g, 2);
  const auto bax = ld(g, 3) - ax, bay = ld(g, 4) - ay, baz = ld(g, 5) - az;
  const auto ra = ld(g, 6), rb = ld(g, 7);
  const auto rba = rb - ra;
  const auto baba = pmax(bax * bax + bay * bay + baz * baz, 1e-20f);
  T pax = px - ax, pay = py - ay, paz = pz - az;
  T papa = pax * pax + pay * pay + paz * paz;
  T paba = (pax * bax + pay * bay + paz * baz) / baba;
  T x = root<G>(cmax(papa - paba * paba * baba, 1e-20f));
  T cax = cmax(x - (val(paba) < 0.5f ? ra : rb), 0.f);
  T cay = abs_(paba - 0.5f) - 0.5f;
  const auto k = rba * rba + baba;
  T f = clamp01((rba * (x - ra) + paba * baba) / k);
  T cbx = x - ra - f * rba;
  T cby = paba - f;
  float s = (val(cbx) < 0.f && val(cay) < 0.f) ? -1.f : 1.f;
  return s * root<G>(min_(cax * cax + cay * cay * baba,
                        cbx * cbx + cby * cby * baba) + 1e-20f);
}

template <typename T, typename G>
__device__ __forceinline__ T d_plane(const G& g, T px, T py, T pz) {
  return px * ld(g, 0) + py * ld(g, 1) + pz * ld(g, 2) - ld(g, 3);
}

template <typename T, typename G>
__device__ __forceinline__ T prim_dist(int kind, const G& g, T px, T py,
                                       T pz) {
  switch (kind) {
    case K_SPHERE: return d_sphere(g, px, py, pz);
    case K_CAPSULE: return d_capsule(g, px, py, pz);
    case K_TORUS: return d_torus(g, px, py, pz);
    case K_TRIANGLE: return d_triangle(g, px, py, pz);
    case K_BOX: return d_box(g, px, py, pz);
    case K_CONE: return d_cone(g, px, py, pz);
    default: return d_plane(g, px, py, pz);
  }
}

// the same with the kind known at compile time
template <int KIND, typename T, typename G>
__device__ __forceinline__ T kind_dist(const G& g, T px, T py, T pz) {
  if constexpr (KIND == K_SPHERE) return d_sphere(g, px, py, pz);
  else if constexpr (KIND == K_CAPSULE) return d_capsule(g, px, py, pz);
  else if constexpr (KIND == K_TORUS) return d_torus(g, px, py, pz);
  else if constexpr (KIND == K_TRIANGLE) return d_triangle(g, px, py, pz);
  else if constexpr (KIND == K_BOX) return d_box(g, px, py, pz);
  else if constexpr (KIND == K_CONE) return d_cone(g, px, py, pz);
  else return d_plane(g, px, py, pz);
}

// runs CALL with the run-time primitive kind `kind` as the compile-time
// constant K (one dispatch around a loop, not one a row)
#define FT_KIND_SWITCH(kind, CALL)                             \
  switch (kind) {                                              \
    case K_SPHERE: { constexpr int K = K_SPHERE; CALL; } break;     \
    case K_CAPSULE: { constexpr int K = K_CAPSULE; CALL; } break;   \
    case K_TORUS: { constexpr int K = K_TORUS; CALL; } break;       \
    case K_TRIANGLE: { constexpr int K = K_TRIANGLE; CALL; } break; \
    case K_BOX: { constexpr int K = K_BOX; CALL; } break;           \
    case K_CONE: { constexpr int K = K_CONE; CALL; } break;         \
    default: { constexpr int K = K_PLANE; CALL; }                   \
  }

// exact gradient of one primitive's distance at p (forward-mode dual
// numbers), the kind known at run time or at compile time
template <typename G>
__device__ __forceinline__ Dual prim_dual(int kind, const G& g, float px,
                                          float py, float pz) {
  return prim_dist(kind, g, Dual{px, 1.f, 0.f, 0.f}, Dual{py, 0.f, 1.f, 0.f},
                   Dual{pz, 0.f, 0.f, 1.f});
}
template <int KIND, typename G>
__device__ __forceinline__ Dual kind_dual(const G& g, float px, float py,
                                          float pz) {
  return kind_dist<KIND>(g, Dual{px, 1.f, 0.f, 0.f}, Dual{py, 0.f, 1.f, 0.f},
                         Dual{pz, 0.f, 0.f, 1.f});
}

// ---------------------------------------------------------------------------
// warp reductions of floats (order-preserving int image, sm_80+ redux)
// ---------------------------------------------------------------------------

__device__ __forceinline__ int ft_ord(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float ft_unord(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}
__device__ __forceinline__ float warp_min(float x) {
  return ft_unord(__reduce_min_sync(FT_FULL_MASK, ft_ord(x)));
}
__device__ __forceinline__ float warp_max(float x) {
  return ft_unord(__reduce_max_sync(FT_FULL_MASK, ft_ord(x)));
}

// ---------------------------------------------------------------------------
// the scene program's stack values
// ---------------------------------------------------------------------------
//
// The host lowers the CSG plan to a program (groups of primitives with a
// min/max/sumexp reduction, the tree over them in postfix) that a thread
// folds with a value stack.  Three value types, one set of rules:
// - Dist, the distance alone (K1/K2: march_distance);
// - DistCode, the distance, the signed code +-(slot + 1) of the CSG-winning
//   leaf and where that leaf's row is (K3, slot mode): min/max keep the
//   first extremum, subtract flips the sign of its b side.  A smooth
//   reduction names no single leaf (code 0); the host keeps smooth plans
//   out of slot mode;
// - DistGrad, the distance and its gradient at the query point (K3, AD
//   mode, the plans with a smooth union): min/max keep the first
//   extremum's gradient, subtract negates its b side's, a smooth reduction
//   blends the gradients with the weights e = exp(-d / k).  A value that
//   no leaf owns (an empty group, a floored max group) has gradient
//   (0, 0, 1).
// The per-type rules are the overloads below; the folds are march_distance
// (K1/K2) and surface_scene (K3) at the end of this file.

struct Dist {
  float v;
};
// at: the winning leaf's row, -1 none; pair q's table row r as
// r * FT_MAX_PAIRS + q; dense entry e as -(e + 2)
struct DistCode {
  float v, code;
  int at;
};
struct DistGrad {
  float v, x, y, z;
};

// a value that no leaf owns
__device__ __forceinline__ void smooth_value(Dist& a, float v) { a.v = v; }
__device__ __forceinline__ void smooth_value(DistCode& a, float v) {
  a = {v, 0.f, -1};
}
__device__ __forceinline__ void smooth_value(DistGrad& a, float v) {
  a = {v, 0.f, 0.f, 1.f};
}

__device__ __forceinline__ Dist csg_subtract(Dist a, Dist b) {
  return {fmaxf(a.v, -b.v)};
}
__device__ __forceinline__ DistCode csg_subtract(DistCode a, DistCode b) {
  return a.v > -b.v ? a : DistCode{-b.v, -b.code, b.at};
}
__device__ __forceinline__ DistGrad csg_subtract(DistGrad a, DistGrad b) {
  return a.v > -b.v ? a : DistGrad{-b.v, -b.x, -b.y, -b.z};
}
// n-ary union / intersect: the earlier operand wins ties
__device__ __forceinline__ Dist csg_pick(Dist out, Dist v, bool uni) {
  return {uni ? fminf(out.v, v.v) : fmaxf(out.v, v.v)};
}
__device__ __forceinline__ DistCode csg_pick(DistCode out, DistCode v,
                                             bool uni) {
  return (uni ? out.v <= v.v : out.v >= v.v) ? out : v;
}
__device__ __forceinline__ DistGrad csg_pick(DistGrad out, DistGrad v,
                                             bool uni) {
  return (uni ? out.v <= v.v : out.v >= v.v) ? out : v;
}

// smooth union of n stack values: -k log(max(sum e, 1e-30)), e = exp(-v/k);
// the gradient is the e-weighted mean of the operands' gradients
template <typename V>
__device__ __forceinline__ V smooth_fold(const V* st, int n, float k) {
  float s = 0.f;
  for (int j = 0; j < n; ++j) s += expf(-st[j].v / k);
  V out;
  smooth_value(out, -k * logf(fmaxf(s, 1e-30f)));
  return out;
}
__device__ __forceinline__ DistGrad smooth_fold(const DistGrad* st, int n,
                                                float k) {
  float s = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
  for (int j = 0; j < n; ++j) {
    const float e = expf(-st[j].v / k);
    s += e;
    sx += e * st[j].x;
    sy += e * st[j].y;
    sz += e * st[j].z;
  }
  s = fmaxf(s, 1e-30f);
  return {-k * logf(s), sx / s, sy / s, sz / s};
}

struct NoPrimHook {
  __device__ __forceinline__ void operator()(float, int, int) const {}
};

// The instrumented twin of K1/K2 (march.cu, ft_march_sections) passes this
// hook instead: clock64() deltas per section of a warp's march, and counts.
// tick(s) charges the time since the last tick to section s, so the
// sections add up to the warp's whole time.
enum { SEC_LOAD = 0, SEC_WINDOW, SEC_ROWS, SEC_EARLY, SEC_DENSE, SEC_STEP,
       SEC_STORE, SEC_N };
enum { CNT_STEPS = 0, CNT_CHUNKS, CNT_CUT, CNT_N };
struct SectionHook {
  long long acc[SEC_N], cnt[CNT_N], last;
  __device__ __forceinline__ void operator()(float, int, int) const {}
  __device__ __forceinline__ void tick(int s) {
    const long long now = clock64();
    acc[s] += now - last;
    last = now;
  }
};
template <typename H> struct ft_timed { static constexpr bool value = false; };
template <> struct ft_timed<SectionHook> {
  static constexpr bool value = true;
};
template <typename H>
__device__ __forceinline__ void ft_tick(H& h, int s) {
  if constexpr (ft_timed<H>::value) h.tick(s);
}
template <typename H>
__device__ __forceinline__ void ft_count(H& h, int c, int n) {
  if constexpr (ft_timed<H>::value) h.cnt[c] += n;
}

// ---------------------------------------------------------------------------
// K1/K2: the march's scene evaluation (march.cu march_kernel)
// ---------------------------------------------------------------------------
//
// The program folded with Dist values, read where the block staged it
// (FtStage): the program from shared memory (one record an op),
// the dense entries from shared memory when they are few, each culled pair
// through a per-block record whose pointers name the tile's slices in
// shared memory (staged) or in device memory (not staged) — one code path,
// generic loads.

#define FT_MARCH_FAST_ROOTS 1  // sqrt.approx in the march distance

// One culled pair as the block's warps read it (built once per block).
struct SPair {
  const float* tab;   // [m, FT_TABLE_W] the tile's candidates
  const float* keys;  // [2, m / FT_CAND_UNROLL]
  const float* hsuf;  // [m / FT_CAND_UNROLL]
  float clamp, count; // misc[tile]: window clamp, candidate count
  int m, kind, group_size, pad_;
};

// One op of the program as the block staged it: a group op carries its
// group's entry range, reduction, strength and pair range, so a step reads
// one record where the device-memory program takes three dependent reads.
struct SOp {
  int op, arg;   // opcode; operand count (tree ops)
  int e0, e1;    // group: its dense entries [e0, e1)
  int gop;       // group: G_MIN / G_MAX / G_SUMEXP
  int q0, q1;    // group: its culled pairs [q0, q1)
  float k;       // smooth strength (of the group, or of the tree op)
};

// The block's staged view (K1/K2 and K3).
struct MarchCtx {
  const FtProgram& P;
  const FtStage& S;
  const unsigned char* smem;
  int early_out;
  __device__ __forceinline__ const SPair* pairs() const {
    return (const SPair*)(smem + 16);
  }
  __device__ __forceinline__ const SOp* ops() const {
    return (const SOp*)(smem + S.ops_off);
  }
};

// distance to the row at r4 (16-byte words), kind known at compile time:
// only the words the kind reads are loaded
template <int KIND>
__device__ __forceinline__ float row_dist(const float4* r4, float px, float py,
                                          float pz) {
  constexpr int words = (ft_kind_width(KIND) + 3) / 4;
  return kind_dist<KIND>(load_row<words, FT_MARCH_FAST_ROOTS != 0>(r4), px,
                         py, pz);
}

// The window's rows, chunk by chunk: FT_CAND_UNROLL rows in flight on two
// accumulators (min and max are exact in any order).  A warp reads one row
// at a time: a broadcast, no bank conflict.  The running-min early-out
// (min groups) stops before chunk c once no later candidate can lower any
// active lane's running min; before the first chunk every min is FT_BIG
// and the test cannot cut, so it is skipped there.
constexpr int ft_row_pairs_unrolled = 2;  // x2: rows in flight
template <int KIND, typename Hook>
__device__ __forceinline__ float window_rows(const float* tab,
                                             const float* hsuf, int w_lo,
                                             int w_hi, bool mn, bool early_out,
                                             bool active, float phi, float px,
                                             float py, float pz, Hook& hook) {
  const float4* t4 = (const float4*)tab;
  constexpr int row_words = FT_TABLE_W / 4;
  float win = mn ? FT_BIG : -FT_BIG;
  for (int c = w_lo; c < w_hi; ++c) {
    if (early_out && c > w_lo) {
      const float amax = warp_max(active ? win : -FT_BIG);
      const bool cut = !(amax + phi > hsuf[c]);
      ft_tick(hook, SEC_EARLY);
      if (cut) {
        ft_count(hook, CNT_CUT, w_hi - c);
        break;
      }
    }
    const float4* r4 = t4 + (size_t)c * FT_CAND_UNROLL * row_words;
    float a0 = win, a1 = win;
#pragma unroll ft_row_pairs_unrolled
    for (int k = 0; k < FT_CAND_UNROLL; k += 2) {
      const float d0 = row_dist<KIND>(r4 + k * row_words, px, py, pz);
      const float d1 = row_dist<KIND>(r4 + (k + 1) * row_words, px, py, pz);
      a0 = mn ? fminf(a0, d0) : fmaxf(a0, d0);
      a1 = mn ? fminf(a1, d1) : fmaxf(a1, d1);
    }
    win = mn ? fminf(a0, a1) : fmaxf(a0, a1);
    ft_count(hook, CNT_CHUNKS, 1);
    ft_tick(hook, SEC_ROWS);
  }
  return win;
}

// One culled pair's windowed value (march_kernel.py culled_pass :877-980
// with _pair_window :641-697), collective over the warp.  The window is
// the hull of the chunks that are neither behind (max(a+r) < min p_ax -
// clamp) nor ahead (min(a-r) > max p_ax + clamp) of the warp's active
// lanes: two redux for the lanes' axial range, each lane tests the keys of
// its chunks, a ballot finds the hull.  A min group takes min(window min,
// cap) with the per-lane cap min(AH - p_ax, p_ax - BH) over the skipped
// chunks; a max group max(window max, skip_lb, excl), where excl = 2 eps
// floors a group whose cone excluded members.  Only the statistics the
// group's reduction needs are reduced, before the rows, so that their
// latency hides behind the candidate loop.
template <typename Hook>
__device__ __forceinline__ float culled_window(const SPair* q, const Lane& L,
                                               bool mn, int early_out,
                                               float px, float py, float pz,
                                               Hook& hook) {
  const float* keys = q->keys;
  const int chunks = q->m / FT_CAND_UNROLL;
  const int kind = q->kind;
  const float clamp = q->clamp;
  const int lane = threadIdx.x & 31;
  // the plain version rounds o + t*c twice: no FMA here, same windows
  const float p_ax = __fadd_rn(L.oa, __fmul_rn(L.t, L.ca));
  const float plo = warp_min(L.active ? p_ax : FT_BIG);
  const float phi = warp_max(L.active ? p_ax : -FT_BIG);
  const float lo_lim = plo - clamp, hi_lim = phi + clamp;
  int w_lo = chunks, w_hi = 0;
  float bh = -FT_BIG, ah = FT_BIG, bh_min = FT_BIG, ah_max = -FT_BIG;
  unsigned any_b = 0u, any_a = 0u;
#pragma unroll 1
  for (int c0 = 0; c0 < chunks; c0 += 32) {
    const int c = c0 + lane;
    const bool in = c < chunks;
    const float lo = in ? keys[c] : 0.f, hi = in ? keys[chunks + c] : 0.f;
    const bool behind = in && lo < lo_lim, ahead = in && hi > hi_lim;
    const unsigned rel = __ballot_sync(FT_FULL_MASK, in && !behind && !ahead);
    if (rel) {
      if (w_hi == 0) w_lo = c0 + __ffs(rel) - 1;
      w_hi = c0 + 32 - __clz(rel);
    }
    if (behind) {
      bh = fmaxf(bh, lo);
      bh_min = fminf(bh_min, lo);
    }
    if (ahead) {
      ah = fminf(ah, hi);
      ah_max = fmaxf(ah_max, hi);
    }
    if (!mn) {
      any_b |= __ballot_sync(FT_FULL_MASK, behind);
      any_a |= __ballot_sync(FT_FULL_MASK, ahead);
    }
  }
  if (mn) {
    bh = warp_max(bh);
    ah = warp_min(ah);
  } else {
    bh_min = warp_min(bh_min);
    ah_max = warp_max(ah_max);
  }
  ft_tick(hook, SEC_WINDOW);

  const float* tab = q->tab;
  const float* hsuf = q->hsuf;
  const bool eo = mn && early_out;
  float win;
#define FT_WINDOW(K)                                                       \
  case K:                                                                  \
    win = window_rows<K>(tab, hsuf, w_lo, w_hi, mn, eo, L.active, phi, px, \
                         py, pz, hook);                                    \
    break;
  switch (kind) {
    FT_WINDOW(K_SPHERE)
    FT_WINDOW(K_CAPSULE)
    FT_WINDOW(K_TORUS)
    FT_WINDOW(K_TRIANGLE)
    FT_WINDOW(K_BOX)
    FT_WINDOW(K_CONE)
    default:
      win = window_rows<K_PLANE>(tab, hsuf, w_lo, w_hi, mn, eo, L.active, phi,
                                 px, py, pz, hook);
  }
#undef FT_WINDOW
  float out;
  if (mn) {
    out = fminf(win, fminf(ah - p_ax, p_ax - bh));
  } else {
    const float skip_lb = fmaxf(any_b ? p_ax - bh_min : -FT_BIG,
                                any_a ? ah_max - p_ax : -FT_BIG);
    const float excl =
        q->count < (float)q->group_size ? 2.f * L.eps : -FT_BIG;
    out = fmaxf(fmaxf(win, skip_lb), excl);
  }
  ft_tick(hook, SEC_WINDOW);
  return out;
}

// a dense entry's distance: from its staged row (kind bits at FT_PSTRIDE)
// or from device memory, exact roots there as the dense form always had
__device__ __forceinline__ float staged_entry_dist(const float4* r4, float px,
                                                   float py, float pz) {
  const RRow<FT_MARCH_FAST_ROOTS != 0> r =
      load_row<FT_TABLE_W / 4, FT_MARCH_FAST_ROOTS != 0>(r4);
  return prim_dist(__float_as_int(r.v[FT_PSTRIDE]), r, px, py, pz);
}

template <typename Hook>
__device__ __forceinline__ float march_group(const MarchCtx& X, const Lane& L,
                                             const SOp& o, float px, float py,
                                             float pz, Hook& hook) {
  const int e0 = o.e0, e1 = o.e1, op = o.gop;
  const FtProgram& P = X.P;
  const bool mn = op == G_MIN;
  float acc = mn ? FT_BIG : -FT_BIG;
#pragma unroll 1
  for (int q = o.q0; q < o.q1; ++q) {
    ft_tick(hook, SEC_DENSE);
    const float v = culled_window(X.pairs() + q, L, mn, X.early_out, px, py,
                                  pz, hook);
    acc = mn ? fminf(acc, v) : fmaxf(acc, v);
  }
  if (X.S.ents > 0) {
    // staged entries (a culled launch's few): one loop for every reduction
    const float4* rows = (const float4*)(X.smem + X.S.ents_off);
    const float k = o.k;
    float s = 0.f;
#pragma unroll 1
    for (int e = e0; e < e1; ++e) {
      const float d =
          staged_entry_dist(rows + e * (FT_TABLE_W / 4), px, py, pz);
      if (op == G_SUMEXP) {
        s += expf(-d / k);
      } else {
        acc = mn ? fminf(acc, d) : fmaxf(acc, d);
      }
    }
    return op == G_SUMEXP ? -k * logf(fmaxf(s, 1e-30f)) : acc;
  }
  // entries in device memory: the dense form's loop over the whole scene
  if (op == G_SUMEXP) {
    const float k = o.k;
    float s = 0.f;
#pragma unroll 1
    for (int e = e0; e < e1; ++e) {
      const float d = prim_dist(__ldg(P.ent_kind + e),
                                GRow{P.ent_params + (size_t)e * FT_PSTRIDE},
                                px, py, pz);
      s += expf(-d / k);
    }
    return -k * logf(fmaxf(s, 1e-30f));
  }
  for (int e = e0; e < e1; ++e) {
    const float d = prim_dist(__ldg(P.ent_kind + e),
                              GRow{P.ent_params + (size_t)e * FT_PSTRIDE}, px,
                              py, pz);
    acc = mn ? fminf(acc, d) : fmaxf(acc, d);
  }
  return acc;
}

// ---------------------------------------------------------------------------
// The dense form (K1/K2 march_dense_kernel, K3's dense kernels)
// ---------------------------------------------------------------------------
//
// The block stages the program, its kind runs and, while they fit, the
// packed rows of the dense entries (FtDenseStage); a group reads its
// runs one after the other, each with the kind known at compile time, so
// the seven-way dispatch sits outside the row loop and a row is read as
// the 16-byte words its kind needs (a torus 32 bytes, a sphere 16).  Rows
// that did not fit are read from device memory through the same code.

#define FT_DENSE_FAST_ROOTS 1  // sqrt.approx in the dense march distance

// The dense form's staged view.
struct DenseCtx {
  const FtProgram& P;
  const FtDenseStage& S;
  const unsigned char* smem;
  const float4* rows;  // the packed rows: shared memory or P.packed
  const int2* ms;      // (material, slot): shared memory or P.ent_ms
  __device__ __forceinline__ const SOp* ops() const {
    return (const SOp*)(smem + S.ops_off);
  }
  __device__ __forceinline__ const int4* runs() const {
    return (const int4*)(smem + S.runs_off);
  }
};

// A min or max run folded into acc: 4 rows in flight on two accumulators
// (min and max are exact in any order).  A warp reads one row at a time:
// a broadcast.
template <int KIND, bool MN>
__device__ __forceinline__ float run_extremum(const float4* r4, int count,
                                              float acc, float px, float py,
                                              float pz) {
  constexpr int W = (ft_kind_width(KIND) + 3) / 4;
  constexpr bool FAST = FT_DENSE_FAST_ROOTS != 0;
  float a0 = acc, a1 = acc;
  int i = 0;
#pragma unroll 1
  for (; i + 4 <= count; i += 4) {
    const float d0 = kind_dist<KIND>(load_row<W, FAST>(r4 + i * W), px, py,
                                     pz);
    const float d1 = kind_dist<KIND>(load_row<W, FAST>(r4 + (i + 1) * W),
                                     px, py, pz);
    const float d2 = kind_dist<KIND>(load_row<W, FAST>(r4 + (i + 2) * W),
                                     px, py, pz);
    const float d3 = kind_dist<KIND>(load_row<W, FAST>(r4 + (i + 3) * W),
                                     px, py, pz);
    a0 = MN ? fminf(a0, d0) : fmaxf(a0, d0);
    a1 = MN ? fminf(a1, d1) : fmaxf(a1, d1);
    a0 = MN ? fminf(a0, d2) : fmaxf(a0, d2);
    a1 = MN ? fminf(a1, d3) : fmaxf(a1, d3);
  }
#pragma unroll 1
  for (; i < count; ++i) {
    const float d = kind_dist<KIND>(load_row<W, FAST>(r4 + i * W), px, py,
                                    pz);
    a0 = MN ? fminf(a0, d) : fmaxf(a0, d);
  }
  return MN ? fminf(a0, a1) : fmaxf(a0, a1);
}

// A sumexp run added to s in entry order (the float sum keeps its order).
template <int KIND>
__device__ __forceinline__ float run_sumexp(const float4* r4, int count,
                                            float k, float s, float px,
                                            float py, float pz) {
  constexpr int W = (ft_kind_width(KIND) + 3) / 4;
  constexpr bool FAST = FT_DENSE_FAST_ROOTS != 0;
#pragma unroll 1
  for (int i = 0; i < count; ++i) {
    s += expf(-kind_dist<KIND>(load_row<W, FAST>(r4 + i * W), px, py, pz) /
              k);
  }
  return s;
}

// a group of the dense form, run by run (its SOp's q0/q1 name its runs)
template <typename Hook>
__device__ __forceinline__ float march_group(const DenseCtx& X, const Lane&,
                                             const SOp& o, float px,
                                             float py, float pz, Hook&) {
  const int4* runs = X.runs();
  if (o.gop == G_SUMEXP) {
    float s = 0.f;
#pragma unroll 1
    for (int r = o.q0; r < o.q1; ++r) {
      const int4 u = runs[r];
      FT_KIND_SWITCH(u.z, s = run_sumexp<K>(X.rows + u.w, u.y - u.x, o.k, s,
                                            px, py, pz))
    }
    return -o.k * logf(fmaxf(s, 1e-30f));
  }
  const bool mn = o.gop == G_MIN;
  float acc = mn ? FT_BIG : -FT_BIG;
#pragma unroll 1
  for (int r = o.q0; r < o.q1; ++r) {
    const int4 u = runs[r];
    // (the parentheses keep the template's comma out of the macro)
    if (mn) {
      FT_KIND_SWITCH(u.z, (acc = run_extremum<K, true>(
                              X.rows + u.w, u.y - u.x, acc, px, py, pz)))
    } else {
      FT_KIND_SWITCH(u.z, (acc = run_extremum<K, false>(
                              X.rows + u.w, u.y - u.x, acc, px, py, pz)))
    }
  }
  return acc;
}

// The scene's distance: the program folded with Dist values, the groups
// read the culled way (MarchCtx) or the dense way (DenseCtx).
template <typename Ctx, typename Hook>
__device__ __forceinline__ float march_distance(const Ctx& X, const Lane& L,
                                                float px, float py, float pz,
                                                Hook& hook) {
  Dist st[FT_MAX_STACK];
  int sp = 0;
  const SOp* ops = X.ops();
  const int n_ops = X.P.n_ops;
#pragma unroll 1
  for (int i = 0; i < n_ops; ++i) {
    const SOp o = ops[i];
    if (o.op == OP_GROUP) {
      st[sp++] = {march_group(X, L, o, px, py, pz, hook)};
      continue;
    }
    if (o.op == OP_SUBTRACT) {
      const Dist b = st[--sp];
      st[sp - 1] = csg_subtract(st[sp - 1], b);
      continue;
    }
    const int base = sp - o.arg;
    Dist out = st[base];
    if (o.op == OP_SMOOTH) {
      out = smooth_fold(st + base, o.arg, o.k);
    } else {
#pragma unroll 1
      for (int j = 1; j < o.arg; ++j) {
        out = csg_pick(out, st[base + j], o.op == OP_UNION);
      }
    }
    st[base] = out;
    sp = base + 1;
  }
  ft_tick(hook, SEC_DENSE);
  return st[0].v;
}

// ---------------------------------------------------------------------------
// K3: the surface pass's scene evaluation (march.cu surface_kernel,
// surface_ad_kernel)
// ---------------------------------------------------------------------------
//
// The program as the block staged it (MarchCtx, as for K1/K2), folded once
// at a hit lane's point with DistCode (slot mode) or DistGrad (AD mode).  A
// culled pair scans its tile's whole candidate list (culled_sp :1051-1144,
// :1359-1456; no window: a surface point needs the true extremum) with the
// kind known at compile time, one dispatch per pair; rows are read as
// 16-byte words from shared memory (or from the device slice of a pair that
// is not staged), roots are exact: the normals are held to 1e-4.  A group
// folds its pairs first, strictly, then its dense entries in ascending
// slot; on_prim sees every primitive distance (the material argmin).

// argmin of the raw leaf distance over CSG-visible slots; equal distances
// go to the lower slot.  The order is total on (distance, slot), so partial
// argmins merge to the sequential one exactly.
struct MaterialArgmin {
  float md = FT_BIG;
  int mat = -1, mslot = 0x7fffffff;
  __device__ __forceinline__ void operator()(float d, int m, int slot) {
    if (m < 0) return;
    if (d < md || (d == md && slot < mslot)) {
      md = d;
      mat = m;
      mslot = slot;
    }
  }
};

// The scan of one pair: the leaf extremum with ties to the lower slot, and
// its table row.  Slots stay floats as the table holds them (exact
// integers, compared as such); bslot FT_BIG: no leaf owns the value (no
// row beat the start, or a max group's floor, below).
struct PairScan {
  float bd, bslot;
  int brow;
};

__device__ __forceinline__ bool scan_better(bool mn, float d, float slot,
                                            const PairScan& r) {
  return (mn ? d < r.bd : d > r.bd) || (d == r.bd && slot < r.bslot);
}

// The material argmin of a scan's rows, slots and materials as floats
struct RowArgmin {
  float md = FT_BIG, mat = -1.f, mslot = FT_BIG;
  __device__ __forceinline__ void operator()(float d, float m, float slot) {
    if (m < 0.f) return;
    if (d < md || (d == md && slot < mslot)) {
      md = d;
      mat = m;
      mslot = slot;
    }
  }
};

// The first `rows` rows (a multiple of FT_CAND_UNROLL) of a tile's table,
// ft_surface_rows in flight on as many accumulators: the extremum and the
// material argmin are total orders on (distance, slot), so the accumulators
// merge to what one sequential scan gives, bit for bit.
constexpr int ft_surface_rows = 2;
template <int KIND>
__device__ __forceinline__ PairScan scan_rows(const float4* t4, int rows,
                                              bool mn, float px, float py,
                                              float pz,
                                              MaterialArgmin& material) {
  constexpr int row_words = FT_TABLE_W / 4;
  PairScan acc[ft_surface_rows];
  RowArgmin mat[ft_surface_rows];
#pragma unroll
  for (int k = 0; k < ft_surface_rows; ++k) {
    acc[k] = {mn ? FT_BIG : -FT_BIG, FT_BIG, 0};
  }
#pragma unroll 1
  for (int i = 0; i < rows; i += ft_surface_rows) {
#pragma unroll
    for (int k = 0; k < ft_surface_rows; ++k) {
      const RRow<false> r =
          load_row<row_words, false>(t4 + (i + k) * row_words);
      const float d = kind_dist<KIND>(r, px, py, pz);
      const float slot = r.v[FT_PSTRIDE + 1];
      mat[k](d, r.v[FT_PSTRIDE], slot);
      if (scan_better(mn, d, slot, acc[k])) acc[k] = {d, slot, i + k};
    }
  }
#pragma unroll
  for (int k = 0; k < ft_surface_rows; ++k) {
    if (k > 0 && scan_better(mn, acc[k].bd, acc[k].bslot, acc[0])) {
      acc[0] = acc[k];
    }
    if (mat[k].mat >= 0.f) {
      material(mat[k].md, (int)mat[k].mat, (int)mat[k].mslot);
    }
  }
  return acc[0];
}

// One culled pair: its first ceil8(min(count, m)) rows; a max group whose
// cone excluded members and whose extremum lies below 2 eps takes 2 eps,
// owned by no leaf (:1122-1138, :1416-1432).
template <int KIND>
__device__ __forceinline__ PairScan pair_scan(const SPair* q, bool mn,
                                              float eps, float px, float py,
                                              float pz,
                                              MaterialArgmin& material) {
  const int n_c = (int)fminf(q->count, (float)q->m);
  const int rows = (n_c + FT_CAND_UNROLL - 1) / FT_CAND_UNROLL * FT_CAND_UNROLL;
  PairScan r = scan_rows<KIND>((const float4*)q->tab, rows, mn, px, py, pz,
                               material);
  if (!mn && q->count < (float)q->group_size && r.bd < 2.f * eps) {
    r.bd = 2.f * eps;
    r.bslot = FT_BIG;
  }
  return r;
}

// the gradient at p of the row at r4 (16-byte words), kind at compile time
template <int KIND>
__device__ __forceinline__ Dual row_dual(const float4* r4, float px, float py,
                                         float pz) {
  constexpr int words = (ft_kind_width(KIND) + 3) / 4;
  return kind_dual<KIND>(load_row<words, false>(r4), px, py, pz);
}

// a pair's result folded into its group strictly (pair qi of the launch)
template <int KIND>
__device__ __forceinline__ void pair_fold(DistCode& acc, const SPair* q,
                                          int qi, bool mn, float eps,
                                          float px, float py, float pz,
                                          MaterialArgmin& material) {
  const PairScan r = pair_scan<KIND>(q, mn, eps, px, py, pz, material);
  const bool owned = r.bslot != FT_BIG;
  if (mn ? r.bd < acc.v : r.bd > acc.v) {
    acc = {r.bd, owned ? r.bslot + 1.f : 0.f,
           owned ? r.brow * FT_MAX_PAIRS + qi : -1};
  }
}
// AD mode scans the whole list as slot mode does (the TPU body windows the
// scan by the hit shell and caps the value by the skipped chunks' bounds,
// :1372-1432; the winner lies inside that window by construction, so both
// name the same leaf) and evaluates the winner's gradient once, on its row
template <int KIND>
__device__ __forceinline__ void pair_fold(DistGrad& acc, const SPair* q, int,
                                          bool mn, float eps, float px,
                                          float py, float pz,
                                          MaterialArgmin& material) {
  const PairScan r = pair_scan<KIND>(q, mn, eps, px, py, pz, material);
  if (!(mn ? r.bd < acc.v : r.bd > acc.v)) return;
  if (r.bslot == FT_BIG) {
    smooth_value(acc, r.bd);
    return;
  }
  const Dual g = row_dual<KIND>(
      (const float4*)q->tab + r.brow * (FT_TABLE_W / 4), px, py, pz);
  acc = {r.bd, g.t[0], g.t[1], g.t[2]};
}

template <typename V>
__device__ __forceinline__ void surface_pair(V& acc, const SPair* q, int qi,
                                             bool mn, float eps, float px,
                                             float py, float pz,
                                             MaterialArgmin& material) {
#define FT_PAIR(K)                                                   \
  case K:                                                            \
    pair_fold<K>(acc, q, qi, mn, eps, px, py, pz, material);         \
    break;
  switch (q->kind) {
    FT_PAIR(K_SPHERE)
    FT_PAIR(K_CAPSULE)
    FT_PAIR(K_TORUS)
    FT_PAIR(K_TRIANGLE)
    FT_PAIR(K_BOX)
    FT_PAIR(K_CONE)
    default:
      pair_fold<K_PLANE>(acc, q, qi, mn, eps, px, py, pz, material);
  }
#undef FT_PAIR
}

// a dense entry's row (exact roots) and kind: its staged row (kind bits at
// FT_PSTRIDE) or, in the dense form, device memory
__device__ __forceinline__ RRow<false> entry_row(const MarchCtx& X, int e,
                                                 int& kind) {
  RRow<false> r;
  if (X.S.ents > 0) {
    r = load_row<FT_TABLE_W / 4, false>((const float4*)(X.smem + X.S.ents_off)
                                        + e * (FT_TABLE_W / 4));
    kind = __float_as_int(r.v[FT_PSTRIDE]);
  } else {
    const float* p = X.P.ent_params + (size_t)e * FT_PSTRIDE;
#pragma unroll
    for (int j = 0; j < FT_PSTRIDE; ++j) r.v[j] = __ldg(p + j);
    kind = __ldg(X.P.ent_kind + e);
  }
  return r;
}

// the dense form's entry e from device memory, exact roots (the winner's
// gradient: one evaluation a lane)
__device__ __forceinline__ RRow<false> entry_row(const DenseCtx& X, int e,
                                                 int& kind) {
  RRow<false> r;
  const float* p = X.P.ent_params + (size_t)e * FT_PSTRIDE;
#pragma unroll
  for (int j = 0; j < FT_PSTRIDE; ++j) r.v[j] = __ldg(p + j);
  kind = __ldg(X.P.ent_kind + e);
  return r;
}

// the gradient at p of the row at r4, kind at run time (one dispatch)
__device__ __forceinline__ Dual row_dual(int kind, const float4* r4, float px,
                                         float py, float pz) {
#define FT_DUAL(K) \
  case K:          \
    return row_dual<K>(r4, px, py, pz);
  switch (kind) {
    FT_DUAL(K_SPHERE)
    FT_DUAL(K_CAPSULE)
    FT_DUAL(K_TORUS)
    FT_DUAL(K_TRIANGLE)
    FT_DUAL(K_BOX)
    FT_DUAL(K_CONE)
    default:
      return row_dual<K_PLANE>(r4, px, py, pz);
  }
#undef FT_DUAL
}

// slot mode: the gradient of the leaf that won, from its row (DistCode::at)
__device__ __forceinline__ Dual leaf_dual(const MarchCtx& X, int at,
                                          float px, float py, float pz) {
  if (at >= 0) {
    const SPair* q = X.pairs() + at % FT_MAX_PAIRS;
    return row_dual(q->kind,
                    (const float4*)q->tab +
                        (at / FT_MAX_PAIRS) * (FT_TABLE_W / 4),
                    px, py, pz);
  }
  int kind;
  const RRow<false> r = entry_row(X, -at - 2, kind);
  return prim_dual(kind, r, px, py, pz);
}
// the dense form has no pairs: the leaf is an entry
__device__ __forceinline__ Dual leaf_dual(const DenseCtx& X, int at,
                                          float px, float py, float pz) {
  int kind;
  const RRow<false> r = entry_row(X, -at - 2, kind);
  return prim_dual(kind, r, px, py, pz);
}

// group member e (global slot `slot`) with distance d; members run in
// ascending slot, strict compares keep the first extremum.  DistGrad only
// notes the winning entry: its gradient is evaluated once, after the
// group's last member (finish_members)
__device__ __forceinline__ void take_member(DistCode& acc, int&, bool mn,
                                            float d, int slot, int e) {
  if (mn ? d < acc.v : d > acc.v) acc = {d, (float)(slot + 1), -e - 2};
}
__device__ __forceinline__ void take_member(DistGrad& acc, int& won, bool mn,
                                            float d, int, int e) {
  if (mn ? d < acc.v : d > acc.v) {
    acc.v = d;
    won = e;
  }
}
template <typename Ctx>
__device__ __forceinline__ void finish_members(DistCode&, int, const Ctx&,
                                               float, float, float) {}
template <typename Ctx>
__device__ __forceinline__ void finish_members(DistGrad& acc, int won,
                                               const Ctx& X, float px,
                                               float py, float pz) {
  if (won < 0) return;
  int kind;
  const RRow<false> r = entry_row(X, won, kind);
  const Dual g = prim_dual(kind, r, px, py, pz);
  acc = {acc.v, g.t[0], g.t[1], g.t[2]};
}

// a sumexp group's members: sum e, and for DistGrad sum e * gradient
template <typename V>
__device__ __forceinline__ V sumexp_members(const MarchCtx& X, const SOp& o,
                                            float px, float py, float pz,
                                            MaterialArgmin& material, V*) {
  float s = 0.f;
  for (int e = o.e0; e < o.e1; ++e) {
    int kind;
    const RRow<false> r = entry_row(X, e, kind);
    const float d = prim_dist(kind, r, px, py, pz);
    material(d, __ldg(X.P.ent_mat + e), __ldg(X.P.ent_slot + e));
    s += expf(-d / o.k);
  }
  V acc;
  smooth_value(acc, -o.k * logf(fmaxf(s, 1e-30f)));
  return acc;
}
__device__ __forceinline__ DistGrad sumexp_members(const MarchCtx& X,
                                                   const SOp& o, float px,
                                                   float py, float pz,
                                                   MaterialArgmin& material,
                                                   DistGrad*) {
  float s = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
  for (int e = o.e0; e < o.e1; ++e) {
    int kind;
    const RRow<false> r = entry_row(X, e, kind);
    const Dual g = prim_dual(kind, r, px, py, pz);
    material(g.v, __ldg(X.P.ent_mat + e), __ldg(X.P.ent_slot + e));
    const float w = expf(-g.v / o.k);
    s += w;
    sx += w * g.t[0];
    sy += w * g.t[1];
    sz += w * g.t[2];
  }
  s = fmaxf(s, 1e-30f);
  return {-o.k * logf(s), sx / s, sy / s, sz / s};
}

template <typename V>
__device__ __forceinline__ V surface_group(const MarchCtx& X, const SOp& o,
                                           float eps, float px, float py,
                                           float pz,
                                           MaterialArgmin& material) {
  if (o.gop == G_SUMEXP) {
    return sumexp_members(X, o, px, py, pz, material, (V*)nullptr);
  }
  const bool mn = o.gop == G_MIN;
  V acc;
  smooth_value(acc, mn ? FT_BIG : -FT_BIG);
#pragma unroll 1
  for (int q = o.q0; q < o.q1; ++q) {
    surface_pair(acc, X.pairs() + q, q, mn, eps, px, py, pz, material);
  }
  int won = -1;
#pragma unroll 1
  for (int e = o.e0; e < o.e1; ++e) {
    int kind;
    const RRow<false> r = entry_row(X, e, kind);
    const float d = prim_dist(kind, r, px, py, pz);
    const int slot = __ldg(X.P.ent_slot + e);
    material(d, __ldg(X.P.ent_mat + e), slot);
    take_member(acc, won, mn, d, slot, e);
  }
  finish_members(acc, won, X, px, py, pz);
  return acc;
}

// K3's dense form: each min/max group scans its runs with the kind known
// at compile time (rows in flight as scan_rows keeps them, each row's
// material and slot beside it: the order on (distance, slot) is total, so
// the runs' results merge to the sequential scan's); a sumexp group adds
// its members in entry order.  Exact roots; the winner's gradient from
// device memory, once (finish_members, leaf_dual).
template <int KIND>
__device__ __forceinline__ void scan_entry(const float4* r4, const int2* ms,
                                           int e0, int i, bool mn, float px,
                                           float py, float pz, PairScan& acc,
                                           RowArgmin& mat) {
  constexpr int W = (ft_kind_width(KIND) + 3) / 4;
  const float d = kind_dist<KIND>(load_row<W, false>(r4 + i * W), px, py,
                                  pz);
  const int2 m = ms[e0 + i];
  const float slot = (float)m.y;
  mat(d, (float)m.x, slot);
  if (scan_better(mn, d, slot, acc)) acc = {d, slot, e0 + i};
}
// the run of `count` entries from entry e0 whose rows start at r4; brow
// names the winning entry
template <int KIND>
__device__ __forceinline__ PairScan scan_run(const float4* r4, const int2* ms,
                                             int e0, int count, bool mn,
                                             float px, float py, float pz,
                                             MaterialArgmin& material) {
  PairScan acc[ft_surface_rows];
  RowArgmin mat[ft_surface_rows];
#pragma unroll
  for (int k = 0; k < ft_surface_rows; ++k) {
    acc[k] = {mn ? FT_BIG : -FT_BIG, FT_BIG, -1};
  }
  int i = 0;
#pragma unroll 1
  for (; i + ft_surface_rows <= count; i += ft_surface_rows) {
#pragma unroll
    for (int k = 0; k < ft_surface_rows; ++k) {
      scan_entry<KIND>(r4, ms, e0, i + k, mn, px, py, pz, acc[k], mat[k]);
    }
  }
#pragma unroll 1
  for (; i < count; ++i) {
    scan_entry<KIND>(r4, ms, e0, i, mn, px, py, pz, acc[0], mat[0]);
  }
#pragma unroll
  for (int k = 0; k < ft_surface_rows; ++k) {
    if (k > 0 && scan_better(mn, acc[k].bd, acc[k].bslot, acc[0])) {
      acc[0] = acc[k];
    }
    if (mat[k].mat >= 0.f) {
      material(mat[k].md, (int)mat[k].mat, (int)mat[k].mslot);
    }
  }
  return acc[0];
}

// a sumexp run in entry order: sum e (DistCode), or also sum e * gradient
template <int KIND>
__device__ __forceinline__ void sumexp_run(const DenseCtx& X, int4 u, float k,
                                           float px, float py, float pz,
                                           MaterialArgmin& material,
                                           float& s) {
  constexpr int W = (ft_kind_width(KIND) + 3) / 4;
#pragma unroll 1
  for (int i = 0; i < u.y - u.x; ++i) {
    const float d = kind_dist<KIND>(load_row<W, false>(X.rows + u.w + i * W),
                                    px, py, pz);
    const int2 m = X.ms[u.x + i];
    material(d, m.x, m.y);
    s += expf(-d / k);
  }
}
template <int KIND>
__device__ __forceinline__ void sumexp_run(const DenseCtx& X, int4 u, float k,
                                           float px, float py, float pz,
                                           MaterialArgmin& material,
                                           float4& s) {
  constexpr int W = (ft_kind_width(KIND) + 3) / 4;
#pragma unroll 1
  for (int i = 0; i < u.y - u.x; ++i) {
    const Dual g = kind_dual<KIND>(load_row<W, false>(X.rows + u.w + i * W),
                                   px, py, pz);
    const int2 m = X.ms[u.x + i];
    material(g.v, m.x, m.y);
    const float w = expf(-g.v / k);
    s.x += w;
    s.y += w * g.t[0];
    s.z += w * g.t[1];
    s.w += w * g.t[2];
  }
}
template <typename V>
__device__ __forceinline__ V sumexp_runs(const DenseCtx& X, const SOp& o,
                                         float px, float py, float pz,
                                         MaterialArgmin& material, V*) {
  float s = 0.f;
#pragma unroll 1
  for (int r = o.q0; r < o.q1; ++r) {
    const int4 u = X.runs()[r];
    FT_KIND_SWITCH(u.z, sumexp_run<K>(X, u, o.k, px, py, pz, material, s))
  }
  V acc;
  smooth_value(acc, -o.k * logf(fmaxf(s, 1e-30f)));
  return acc;
}
__device__ __forceinline__ DistGrad sumexp_runs(const DenseCtx& X,
                                                const SOp& o, float px,
                                                float py, float pz,
                                                MaterialArgmin& material,
                                                DistGrad*) {
  float4 s = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
  for (int r = o.q0; r < o.q1; ++r) {
    const int4 u = X.runs()[r];
    FT_KIND_SWITCH(u.z, sumexp_run<K>(X, u, o.k, px, py, pz, material, s))
  }
  s.x = fmaxf(s.x, 1e-30f);
  return {-o.k * logf(s.x), s.y / s.x, s.z / s.x, s.w / s.x};
}

template <typename V>
__device__ __forceinline__ V surface_group(const DenseCtx& X, const SOp& o,
                                           float, float px, float py,
                                           float pz,
                                           MaterialArgmin& material) {
  if (o.gop == G_SUMEXP) {
    return sumexp_runs(X, o, px, py, pz, material, (V*)nullptr);
  }
  const bool mn = o.gop == G_MIN;
  PairScan best = {mn ? FT_BIG : -FT_BIG, FT_BIG, -1};
#pragma unroll 1
  for (int r = o.q0; r < o.q1; ++r) {
    const int4 u = X.runs()[r];
    PairScan run;
    FT_KIND_SWITCH(u.z, run = scan_run<K>(X.rows + u.w, X.ms, u.x, u.y - u.x,
                                          mn, px, py, pz, material))
    if (scan_better(mn, run.bd, run.bslot, best)) best = run;
  }
  V acc;
  smooth_value(acc, mn ? FT_BIG : -FT_BIG);
  int won = -1;
  if (best.brow >= 0) {
    take_member(acc, won, mn, best.bd, (int)best.bslot, best.brow);
  }
  finish_members(acc, won, X, px, py, pz);
  return acc;
}

template <typename V, typename Ctx>
__device__ __forceinline__ V surface_scene(const Ctx& X, float eps,
                                           float px, float py, float pz,
                                           MaterialArgmin& material) {
  V st[FT_MAX_STACK];
  int sp = 0;
  const SOp* ops = X.ops();
  const int n_ops = X.P.n_ops;
#pragma unroll 1
  for (int i = 0; i < n_ops; ++i) {
    const SOp o = ops[i];
    if (o.op == OP_GROUP) {
      st[sp++] = surface_group<V>(X, o, eps, px, py, pz, material);
      continue;
    }
    if (o.op == OP_SUBTRACT) {
      const V b = st[--sp];
      st[sp - 1] = csg_subtract(st[sp - 1], b);
      continue;
    }
    const int base = sp - o.arg;
    V out = st[base];
    if (o.op == OP_SMOOTH) {
      out = smooth_fold(st + base, o.arg, o.k);
    } else {
#pragma unroll 1
      for (int j = 1; j < o.arg; ++j) {
        out = csg_pick(out, st[base + j], o.op == OP_UNION);
      }
    }
    st[base] = out;
    sp = base + 1;
  }
  return st[0];
}

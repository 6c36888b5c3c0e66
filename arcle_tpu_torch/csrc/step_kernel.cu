// One whole O2ARC / ARC / Raw env transition per warp, for Hopper.
//
// Replaces the TPU Pallas megakernel arcle_tpu/ops/pallas_step.py::_step_kernel
// (launched through pl.pallas_call in _step_impl).  It computes what the JAX
// package's XLA path computes (arcle_tpu/ops/table.py::step_deferred followed
// by finish_flood), bit for bit, and folds the reward / bookkeeping epilogue
// in: steps, last_action_op, last_reward, submit_count, terminated.
//
// What bounds it on an H100.  An env-step reads the grid and the selection,
// the fields its op leaves alone (to copy them through) and, for a few ops,
// `input`, `answer` or the stored object, and writes 6 grids: about 10.2 KB
// at 30x30 under the uniform O2ARCv2 mix with random bbox actions, some
// 42 MB per launch at B=4096, about 12.5 us at 3.35 TB/s.  The arithmetic is
// a few dozen integer operations per cell.  So the kernel is bound by memory,
// provided enough bytes are in flight and no barrier chain or serial loop
// sits between the loads and the stores; the object ops, whose cells go
// through index maps, are the slowest warps of a launch.
//
// Design.
//   * One warp per env, kEnvsPerBlock envs per block, no block barrier at
//     all: the op, and so the branch, is uniform across the warp, and every
//     reduction is a warp reduction (__reduce_*_sync, __any_sync).  The
//     selection statistics (any, total, max, first index of the max, bbox)
//     come from one pass over the selection and one round of reductions.
//     32 warps per SM are resident, so B=4096 runs in one wave on 132 SMs.
//   * The op is read first.  Every row the op reads at scattered indices
//     (grid, selection, and per group clip, input, answer) is then
//     requested at once with 4-byte cp.async copies into the warp's shared
//     rows; the rows only the selection's statistics call for (a stored
//     object that moves on, the input of a Copy) follow them, so no row is
//     read that the op does not use.  The rows the op leaves alone are
//     copied through at the end, 8 words per lane in flight before the
//     first store.  Each lane moves whole 4-cell words, so a warp instruction
//     moves 128 contiguous bytes.  (A 900-byte env row starts on a 4-byte
//     boundary only, which rules out 16-byte bulk copies of a single env.)
//   * Geometry is a template parameter: 30x30 and 5x5 are compiled with
//     constant H and W, so c / W and the floor-mods become multiplies; one
//     cell-wide instantiation with runtime H, W takes any other
//     H*W <= 1024.
//   * FLOOD finishes the component exactly, as a bitboard: lane r holds row
//     r as a 32-bit mask (H, W <= 32).  A round spreads the front along each
//     row in O(1) with the carry trick on the region mask (and its bit
//     reverse), then one row up and down by shuffles, until __all_sync sees
//     no change, so the rounds count the path's vertical turns.  Grids wider
//     or taller than 32 keep a relaxation over a shared-memory mask.
//     `pending` is always false and no batch-level fix-up follows.
//   * OBJECT runs three passes over shared buffers: the buffers from the
//     selection, the transformed buffers (rot90 / rot270 / flips are index
//     maps followed by the re-anchor roll, transform_src, reproducing the
//     JAX package's whole buffer, not only the window), and their placement:
//     the value at (r, c) is patch[(r - x) mod H][(c - y) mod W] inside the
//     window.
//   * All arithmetic on int8 state is done in int and cast to int8 on the
//     store (wraparound as in the reference); floor division and modulo of
//     possibly negative values go through floordiv / floormod.
//
// The file also holds the engine epilogue (engine_epilogue, below), which runs
// after this kernel in every batched step.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared library
// with a plain C interface (ops/step_kernel.py loads it with ctypes).

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kEnvsPerBlock = 4;                 // one warp per env
constexpr int kThreads = 32 * kEnvsPerBlock;
constexpr int kMinBlocksPerSM = 8;               // 32 resident warps per SM
constexpr int kMinBlocksRuntime = 6;             // runtime H, W: no spills
constexpr int kMaxCells = 1024;
constexpr unsigned kFull = 0xffffffffu;

// group codes (arcle_tpu/ops/groups.py::G)
enum Group {
  NOOP = 0, COLOR = 1, FLOOD = 2, OBJECT = 3, COPY = 4, PASTE = 5,
  COPY_FROM_INPUT = 6, RESET_GRID = 7, RESIZE_GRID = 8, CROP_GRID = 9,
  SUBMIT = 10, RESIZE_TO_ANSWER = 11
};

// object kinds (arcle_tpu/ops/groups.py::OBJ)
enum ObjKind {
  MOVE_U = 0, MOVE_D = 1, MOVE_R = 2, MOVE_L = 3, ROT_90 = 4, ROT_270 = 5,
  FLIP_H = 6, FLIP_V = 7, FLIP_D0 = 8, FLIP_D1 = 9
};

struct Params {
  // inputs: grids int8 [B, P]
  const int8_t* grid; const int8_t* input; const int8_t* answer;
  const int8_t* selected; const int8_t* clip; const int8_t* object;
  const int8_t* object_sel; const int8_t* background; const int8_t* selection;
  // inputs: dims int8 [B, 2]
  const int8_t* grid_dim; const int8_t* input_dim; const int8_t* answer_dim;
  const int8_t* clip_dim; const int8_t* object_dim; const int8_t* object_pos;
  // inputs: per-env int8 [B]
  const int8_t* trials_remain; const int8_t* terminated; const int8_t* active;
  const int8_t* rotation_parity; const int8_t* reset_on_submit;
  // inputs: per-env int32 [B]
  const int32_t* steps; const int32_t* submit_count; const int32_t* operation;
  // the op table, int32 [3, n_ops]: group, param, reset_sel
  const int32_t* table;
  // outputs: grids int8 [B, P]
  int8_t* o_grid; int8_t* o_selected; int8_t* o_clip; int8_t* o_object;
  int8_t* o_object_sel; int8_t* o_background;
  // outputs: dims int8 [B, 2]
  int8_t* o_grid_dim; int8_t* o_clip_dim; int8_t* o_object_dim;
  int8_t* o_object_pos;
  // outputs: per-env
  int8_t* o_trials_remain; int8_t* o_terminated; int8_t* o_active;
  int8_t* o_rotation_parity;
  int32_t* o_steps; int32_t* o_submit_count; int32_t* o_last_action_op;
  float* o_reward; bool* o_term; bool* o_pending;
  int B, H, W, n_ops, max_trial, submit_op;
};

// A word of V cells: 4 cells in a uint32 where the row length allows it,
// else one cell.
template <int V> struct Word;
template <> struct Word<4> { using T = uint32_t; };
template <> struct Word<1> { using T = uint8_t; };

template <int V>
__device__ __forceinline__ int cell(typename Word<V>::T w, int b) {
  return static_cast<int8_t>(static_cast<uint8_t>(w >> (8 * b)));
}

template <int V>
__device__ __forceinline__ typename Word<V>::T put(typename Word<V>::T w,
                                                   int b, int v) {
  using T = typename Word<V>::T;
  return static_cast<T>(w | (static_cast<uint32_t>(static_cast<uint8_t>(v))
                             << (8 * b)));
}

template <int V>
__device__ __forceinline__ typename Word<V>::T ldw(const int8_t* row, int w) {
  return reinterpret_cast<const typename Word<V>::T*>(row)[w];
}

template <int V>
__device__ __forceinline__ void stw(int8_t* row, int w,
                                    typename Word<V>::T v) {
  reinterpret_cast<typename Word<V>::T*>(row)[w] = v;
}

// 4-byte asynchronous copy global -> shared (completes at async_wait_all).
__device__ __forceinline__ void async_copy4(int8_t* dst, const int8_t* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
#else
  *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
#endif
}

__device__ __forceinline__ void async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Request one env row of n_words words into shared memory.
template <int V>
__device__ __forceinline__ void stage(int8_t* dst, const int8_t* src,
                                      int n_words, int lane) {
  for (int w = lane; w < n_words; w += 32) {
    if (V == 4) async_copy4(dst + 4 * w, src + 4 * w);
    else dst[w] = src[w];
  }
}

// Copy one env row through (or zero it), word by word: each lane loads up
// to kChunk words before it stores any, since a store to `dst` might alias
// `src` and would otherwise hold every next load back.
template <int V>
__device__ __forceinline__ void copy_row(int8_t* dst, const int8_t* src,
                                         bool zero, int n_words, int lane) {
  using T = typename Word<V>::T;
  constexpr int kChunk = 8;
  for (int w0 = lane; w0 < n_words; w0 += 32 * kChunk) {
    T v[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int w = w0 + 32 * k;
      v[k] = (!zero && w < n_words) ? ldw<V>(src, w) : T(0);
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int w = w0 + 32 * k;
      if (w < n_words) stw<V>(dst, w, v[k]);
    }
  }
}

// Write one env row whose cell c is f(c).
template <int V, class F>
__device__ __forceinline__ void emit(int8_t* dst, int n_words, int lane,
                                     F f) {
  using T = typename Word<V>::T;
  for (int w = lane; w < n_words; w += 32) {
    T out = 0;
#pragma unroll
    for (int b = 0; b < V; ++b) out = put<V>(out, b, f(w * V + b));
    stw<V>(dst, w, out);
  }
}

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int floormod(int a, int b) {
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// Cells of row `f` reachable from its set bits through set bits of
// `region` towards the high bits (f is a subset of region): the carry of
// region + f runs through each run of region above a bit of f.
__device__ __forceinline__ uint32_t spread_up(uint32_t f, uint32_t region) {
  return (((region + f) ^ region) & region) | f;
}

__device__ __forceinline__ uint32_t spread_row(uint32_t f, uint32_t region) {
  const uint32_t up = spread_up(f, region);
  const uint32_t down = __brev(spread_up(__brev(f), __brev(region)));
  return up | down;
}

__device__ __forceinline__ int wrap(int v, int n) { return v >= n ? v - n : v; }

// Source cell of the object transform `kind` for output cell (i, j) of a
// square H x W buffer whose patch is h x w (pre-transform dims).  Matches
// arcle_tpu/ops/groups.py::_transform_buffer: the jnp rot90 / flip followed
// by a roll of (w - W) or (h - H) along one axis; the rolls come in as
// wH = (W - w) mod H, wW = (W - w) mod W, hH = (H - h) mod H and
// hW = (H - h) mod W.
__device__ __forceinline__ int transform_src(int kind, int i, int j, int wH,
                                             int wW, int hH, int hW, int H,
                                             int W) {
  switch (kind) {
    case ROT_90:   // R[i][j] = buf[j][W-1-i], rolled by w-W along rows
      return j * W + (W - 1 - wrap(i + wH, H));
    case ROT_270:  // R[i][j] = buf[H-1-j][i], rolled by h-H along columns
      return (H - 1 - wrap(j + hW, W)) * W + i;
    case FLIP_H:   // buf[i][W-1-j], rolled by w-W along columns
      return i * W + (W - 1 - wrap(j + wW, W));
    case FLIP_V:   // buf[H-1-i][j], rolled by h-H along rows
      return (H - 1 - wrap(i + hH, H)) * W + j;
    case FLIP_D0:  // transpose
      return j * W + i;
    case FLIP_D1:  // rot180 then transpose, rolled by w-W (rows), h-H (cols)
      return (H - 1 - wrap(j + hW, W)) * W + (W - 1 - wrap(i + wH, H));
    default:       // moves keep the buffer
      return i * W + j;
  }
}

// A warp's shared rows: `aux0` / `aux1` / `aux2` hold what the op reads
// besides grid and selection (object, object_sel and background; clip;
// input and answer); `objc` / `objd` the transformed object buffers;
// `rows` the flood component as row masks.
template <int PP>
struct alignas(16) EnvRows {
  int8_t grid[PP];
  int8_t sel[PP];
  int8_t aux0[PP];
  int8_t aux1[PP];
  int8_t aux2[PP];
  int8_t objc[PP];
  int8_t objd[PP];
  uint32_t rows[32];
};

template <int H_, int W_, int V>
__global__ void __launch_bounds__(kThreads,
                                  H_ ? kMinBlocksPerSM : kMinBlocksRuntime)
step_kernel(const Params p) {
  constexpr int PP = H_ ? ((H_ * W_ + 15) / 16) * 16 : kMaxCells;
  __shared__ EnvRows<PP> smem[kEnvsPerBlock];
  using T = typename Word<V>::T;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int env = blockIdx.x * kEnvsPerBlock + warp;
  if (env >= p.B) return;                 // the ragged last block
  EnvRows<PP>& s = smem[warp];
  const int H = H_ ? H_ : p.H, W = H_ ? W_ : p.W, P = H * W;
  const int NW = P / V;
  const size_t gbase = static_cast<size_t>(env) * P;
  const int d = 2 * env;

  // ---- the op first, then every grid it reads, all in flight at once ----
  int op = p.operation[env];
  op = op < 0 ? 0 : (op > p.n_ops - 1 ? p.n_ops - 1 : op);
  const int grp = p.table[op];
  const int par = p.table[p.n_ops + op];
  const int rs = p.table[2 * p.n_ops + op];
  const int trials = p.trials_remain[env];
  const int active0 = rs ? 0 : p.active[env];   // reset_sel decorator
  const int ros = p.reset_on_submit[env];
  const bool sub_ros = grp == SUBMIT && trials != 0 && ros != 0;
  const int gh = p.grid_dim[d], gw = p.grid_dim[d + 1];
  const int ih = p.input_dim[d], iw = p.input_dim[d + 1];
  const int ah = p.answer_dim[d], aw = p.answer_dim[d + 1];
  const int ch = p.clip_dim[d], cw = p.clip_dim[d + 1];
  const int oh = p.object_dim[d], ow = p.object_dim[d + 1];
  const int ox = p.object_pos[d], oy = p.object_pos[d + 1];
  const int term = p.terminated[env];
  const int parity = p.rotation_parity[env];
  const int steps0 = p.steps[env], submits0 = p.submit_count[env];

  const bool need_sel = grp == COLOR || grp == FLOOD || grp == OBJECT ||
                        grp == COPY || grp == PASTE || grp == RESIZE_GRID ||
                        grp == CROP_GRID;
  // RESIZE_GRID zeroes the grid under a selection, or else copies it
  // through from global memory; a re-initialising Submit replaces it
  const bool need_grid = grp != COPY_FROM_INPUT && grp != RESET_GRID &&
                         grp != RESIZE_GRID && !sub_ros;
  if (need_grid) stage<V>(s.grid, p.grid + gbase, NW, lane);
  if (need_sel) stage<V>(s.sel, p.selection + gbase, NW, lane);
  if (grp == PASTE) {
    stage<V>(s.aux0, p.clip + gbase, NW, lane);
  } else if (grp == SUBMIT) {               // aux0: the input, aux1: answer
    if (sub_ros) stage<V>(s.aux0, p.input + gbase, NW, lane);
    stage<V>(s.aux1, p.answer + gbase, NW, lane);
  }

  async_wait_all();
  __syncwarp();

  // ---- selection statistics: one pass, one round of warp reductions ----
  int any = 0, total = 0, maxv = INT_MIN, maxi = INT_MAX;
  int rmin = INT_MAX, rmax = -1, cmin = INT_MAX, cmax = -1;
  if (need_sel) {
    for (int w = lane; w < NW; w += 32) {
      const T word = ldw<V>(s.sel, w);
      if (word == 0) {                    // V empty cells
        if (maxv < 0) { maxv = 0; maxi = w * V; }
        continue;
      }
#pragma unroll
      for (int b = 0; b < V; ++b) {
        const int c = w * V + b, v = cell<V>(word, b);
        total += v;
        if (v > maxv) { maxv = v; maxi = c; }
        if (v != 0) {
          const int r = c / W, col = c - r * W;
          any = 1;
          rmin = min(rmin, r); rmax = max(rmax, r);
          cmin = min(cmin, col); cmax = max(cmax, col);
        }
      }
    }
    any = __any_sync(kFull, any);
    total = __reduce_add_sync(kFull, total);
    const int lane_max = maxv;
    maxv = __reduce_max_sync(kFull, maxv);
    maxi = __reduce_min_sync(kFull, lane_max == maxv ? maxi : INT_MAX);
    rmin = __reduce_min_sync(kFull, rmin);
    rmax = __reduce_max_sync(kFull, rmax);
    cmin = __reduce_min_sync(kFull, cmin);
    cmax = __reduce_max_sync(kFull, cmax);
  }
  if (!any) { rmin = rmax = cmin = cmax = 0; }
  const int h_s = rmax - rmin + 1, w_s = cmax - cmin + 1;

  // ---- the rows the selection decides on: a stored object that moves on
  // (no selection), the input a Copy takes its selection from ----
  const bool stored = grp == OBJECT && !any && active0;
  // strictly-greater bound, as in the reference (object.py:301)
  const bool copy_ok = grp == COPY && any &&
                       !(rmax > (par == 0 ? ih : gh) ||
                         cmax > (par == 0 ? iw : gw));
  if (stored) {
    stage<V>(s.aux0, p.object + gbase, NW, lane);
    stage<V>(s.aux1, p.object_sel + gbase, NW, lane);
    stage<V>(s.aux2, p.background + gbase, NW, lane);
  } else if (copy_ok && par == 0) {
    stage<V>(s.aux0, p.input + gbase, NW, lane);
  }
  if (stored || (copy_ok && par == 0)) {
    async_wait_all();
    __syncwarp();
  }

  // Selection-shifted views: the grid / selection / input with the bbox
  // corner moved to the origin (jnp roll semantics; 0 <= rmin < H).
  auto shifted = [&](int c) {
    const int r = c / W, col = c - r * W;
    return wrap(r + rmin, H) * W + wrap(col + cmin, W);
  };
  auto in_sel_window = [&](int c, int sc) {
    const int r = c / W, col = c - r * W;
    return r < h_s && col < w_s && s.sel[sc] != 0;
  };
  auto grid_of = [&](int c) { return static_cast<int>(s.grid[c]); };

  // outputs defaulting to the (decorated) pre-op state
  int n_gh = gh, n_gw = gw, n_ch = ch, n_cw = cw;
  int n_oh = oh, n_ow = ow, n_ox = ox, n_oy = oy;
  int n_active = active0, n_parity = parity;
  int n_trials = trials, n_term = term, submitted = 0, reward_match = 0;
  // which grids besides `grid` this op replaces (warp-uniform)
  bool obj_ok = false;
  int8_t* o_grid = p.o_grid + gbase;

  switch (grp) {
    case COLOR: {
      emit<V>(o_grid, NW, lane, [&](int c) {
        return s.sel[c] != 0 ? par : grid_of(c);
      });
      break;
    }
    case FLOOD: {
      // seed: the first cell holding the selection's max (jnp.argmax)
      const int px = maxi / W, py = maxi - px * W;
      const bool valid = total == 1 && px < gh && py < gw;
      if (!valid) {
        copy_row<V>(o_grid, s.grid, false, NW, lane);
        break;
      }
      const int seed = s.grid[maxi];
      if (H <= 32 && W <= 32) {
        // lane r owns row r of the region and of the component
        uint32_t region = 0;
        if (lane < H && lane < gh) {
          for (int j = 0; j < W; ++j)
            if (j < gw && s.grid[lane * W + j] == seed) region |= 1u << j;
        }
        uint32_t f = lane == px ? (1u << py) : 0u;
        for (;;) {
          f = spread_row(f, region);
          const uint32_t above = __shfl_up_sync(kFull, f, 1);
          const uint32_t below = __shfl_down_sync(kFull, f, 1);
          const uint32_t g = region & (f | above | below);
          if (__all_sync(kFull, g == f)) break;
          f = g;
        }
        s.rows[lane] = f;
        __syncwarp();
        emit<V>(o_grid, NW, lane, [&](int c) {
          const int r = c / W, col = c - r * W;
          return (s.rows[r] >> col) & 1u ? par : grid_of(c);
        });
      } else {
        // relax a shared-memory mask until the component stops growing
        volatile int8_t* fl = s.aux0;
        for (int c = lane; c < P; c += 32) fl[c] = c == maxi ? 1 : 0;
        __syncwarp();
        for (;;) {
          int changed = 0;
          for (int c = lane; c < P; c += 32) {
            const int r = c / W, col = c - r * W;
            if (fl[c] || s.grid[c] != seed || r >= gh || col >= gw) continue;
            if ((r > 0 && fl[c - W]) || (r < H - 1 && fl[c + W]) ||
                (col > 0 && fl[c - 1]) || (col < W - 1 && fl[c + 1])) {
              fl[c] = 1;
              changed = 1;
            }
          }
          __syncwarp();
          if (!__any_sync(kFull, changed)) break;
        }
        emit<V>(o_grid, NW, lane, [&](int c) {
          return fl[c] ? par : grid_of(c);
        });
      }
      break;
    }
    case OBJECT: {
      const bool has_sel = any != 0;
      obj_ok = has_sel || active0 != 0;
      if (!obj_ok) {
        copy_row<V>(o_grid, s.grid, false, NW, lane);
        break;
      }
      // _init_objsel: the buffers from the selection into aux0 / aux1, or
      // the stored ones, staged there already
      int8_t* A = s.aux0;
      int8_t* M = s.aux1;
      if (has_sel) {
        for (int wd = lane; wd < NW; wd += 32) {
          T a_out = 0, m_out = 0;
#pragma unroll
          for (int b = 0; b < V; ++b) {
            const int c = wd * V + b, sc = shifted(c);
            const bool in = in_sel_window(c, sc);
            a_out = put<V>(a_out, b, in ? grid_of(sc) : 0);
            m_out = put<V>(m_out, b, in ? 1 : 0);
          }
          stw<V>(A, wd, a_out);
          stw<V>(M, wd, m_out);
        }
        __syncwarp();
      }
      const int x = has_sel ? rmin : ox, y = has_sel ? cmin : oy;
      const int h = has_sel ? h_s : oh, w = has_sel ? w_s : ow;
      const int par0 = has_sel ? 0 : parity;
      const int kind = par;
      const bool is_move = kind <= MOVE_L;
      const bool is_rot = kind == ROT_90 || kind == ROT_270;
      const int dx = kind == MOVE_U ? -1 : (kind == MOVE_D ? 1 : 0);
      const int dy = kind == MOVE_R ? 1 : (kind == MOVE_L ? -1 : 0);
      // rotation anchor in doubled integers (object.py:186-207)
      const bool same_par = floormod(h, 2) == floormod(w, 2);
      const int par_rot = same_par ? par0 : floormod(par0 + 1, 2);
      const int mod = 1 - par_rot;
      const int x_rot = same_par ? floordiv(2 * x + h - w, 2)
                                 : floordiv(2 * x + h - w - 1, 2) + mod;
      const int y_rot = same_par ? floordiv(2 * y + w - h, 2)
                                 : floordiv(2 * y + w - h - 1, 2) + mod;
      const int x2 = is_move ? x + dx : (is_rot ? x_rot : x);
      const int y2 = is_move ? y + dy : (is_rot ? y_rot : y);
      const int h2 = is_rot ? w : h, w2 = is_rot ? h : w;
      // the transformed buffers, whole (moves keep them as they are)
      const int8_t* C = is_move ? A : s.objc;
      const int8_t* D = is_move ? M : s.objd;
      int8_t* o_obj = p.o_object + gbase;
      int8_t* o_osel = p.o_object_sel + gbase;
      if (is_move) {
        copy_row<V>(o_obj, A, false, NW, lane);
        copy_row<V>(o_osel, M, false, NW, lane);
      } else {
        const int wH = floormod(W - w, H), wW = floormod(W - w, W);
        const int hH = floormod(H - h, H), hW = floormod(H - h, W);
        for (int wd = lane; wd < NW; wd += 32) {
          T c_out = 0, d_out = 0;
#pragma unroll
          for (int b = 0; b < V; ++b) {
            const int c = wd * V + b, i = c / W, j = c - i * W;
            const int src = transform_src(kind, i, j, wH, wW, hH, hW, H, W);
            c_out = put<V>(c_out, b, A[src]);
            d_out = put<V>(d_out, b, M[src]);
          }
          stw<V>(s.objc, wd, c_out);
          stw<V>(s.objd, wd, d_out);
          stw<V>(o_obj, wd, c_out);
          stw<V>(o_osel, wd, d_out);
        }
        __syncwarp();
      }
      // _apply_patch / _apply_sel: place them at (x2, y2)
      const int xm = floormod(-x2, H), ym = floormod(-y2, W);
      int8_t* o_sel = p.o_selected + gbase;
      int8_t* o_bg = p.o_background + gbase;
      for (int wd = lane; wd < NW; wd += 32) {
        T g_out = 0, s_out = 0, bg_out = 0;
#pragma unroll
        for (int b = 0; b < V; ++b) {
          const int c = wd * V + b, i = c / W, j = c - i * W;
          const bool win = i >= x2 && i < x2 + h2 && j >= y2 &&
                           j < y2 + w2 && i < gh && j < gw;
          const int s2 = wrap(i + xm, H) * W + wrap(j + ym, W);
          const int vals = C[s2];
          const int bg = has_sel ? (s.sel[c] != 0 ? 0 : grid_of(c))
                                 : static_cast<int>(s.aux2[c]);
          g_out = put<V>(g_out, b, (win && vals != 0) ? vals : bg);
          s_out = put<V>(s_out, b, win ? static_cast<int>(D[s2]) : 0);
          bg_out = put<V>(bg_out, b, bg);
        }
        stw<V>(o_grid, wd, g_out);
        stw<V>(o_sel, wd, s_out);
        stw<V>(o_bg, wd, bg_out);
      }
      n_ox = x2; n_oy = y2; n_oh = h2; n_ow = w2;
      n_active = 1;
      n_parity = is_rot ? par_rot : par0;
      break;
    }
    case COPY: {
      copy_row<V>(o_grid, s.grid, false, NW, lane);
      if (copy_ok) {
        const int8_t* src = par == 0 ? s.aux0 : s.grid;
        emit<V>(p.o_clip + gbase, NW, lane, [&](int c) {
          const int sc = shifted(c);
          const int v = src[sc];
          return (in_sel_window(c, sc) && v != 0) ? v : 0;
        });
        n_ch = h_s; n_cw = w_s;
      }
      break;
    }
    case PASTE: {
      const bool valid = any && ch != 0 && cw != 0;
      const bool blank = par != 0;
      emit<V>(o_grid, NW, lane, [&](int c) {
        const int i = c / W, j = c - i * W;
        int out = grid_of(c);
        if (valid && i >= rmin && i < rmin + ch && j >= cmin &&
            j < cmin + cw) {
          const int v = s.aux0[floormod(i - rmin, H) * W +
                               floormod(j - cmin, W)];
          if (blank || v != 0) out = v;
        }
        return out;
      });
      break;
    }
    case COPY_FROM_INPUT: {
      copy_row<V>(o_grid, p.input + gbase, false, NW, lane);
      n_gh = ih; n_gw = iw;
      break;
    }
    case RESET_GRID: {
      copy_row<V>(o_grid, nullptr, true, NW, lane);
      break;
    }
    case RESIZE_GRID: {
      copy_row<V>(o_grid, p.grid + gbase, any != 0, NW, lane);
      if (any) { n_gh = h_s; n_gw = w_s; }
      break;
    }
    case CROP_GRID: {
      if (any) {
        emit<V>(o_grid, NW, lane, [&](int c) {
          const int sc = shifted(c);
          const int v = grid_of(sc);
          return (in_sel_window(c, sc) && v != 0) ? v : 0;
        });
        n_gh = h_s; n_gw = w_s;
      } else {
        copy_row<V>(o_grid, s.grid, false, NW, lane);
      }
      break;
    }
    case RESIZE_TO_ANSWER: {
      emit<V>(o_grid, NW, lane, [&](int c) {
        const int r = c / W, col = c - r * W;
        return (r < ah && col < aw) ? grid_of(c) : 0;
      });
      n_gh = ah; n_gw = aw;
      break;
    }
    case SUBMIT: {
      // answers_match of the grid the reward reads: the fresh grid (the
      // input) on a re-initialising Submit, else the pre-op grid
      const int8_t* seen = sub_ros ? s.aux0 : s.grid;
      const int sh = sub_ros ? ih : gh, sw = sub_ros ? iw : gw;
      int wrong = 0;
      for (int c = lane; c < P; c += 32) {
        const int r = c / W, col = c - r * W;
        if (r < ah && col < aw) wrong |= seen[c] != s.aux1[c];
      }
      wrong = __any_sync(kFull, wrong);
      const bool match = sh == ah && sw == aw && !wrong;
      const bool can = trials != 0;
      submitted = can;
      reward_match = match;
      if (sub_ros) {
        // init_state: the grid is the input, zeroed outside input_dim
        emit<V>(o_grid, NW, lane, [&](int c) {
          const int r = c / W, col = c - r * W;
          return (r < ih && col < iw) ? static_cast<int>(s.aux0[c]) : 0;
        });
        n_gh = ih; n_gw = iw; n_ch = n_cw = 0;
        n_oh = n_ow = n_ox = n_oy = 0;
        n_active = 0; n_parity = 0;
        n_trials = p.max_trial; n_term = 0;
      } else {
        copy_row<V>(o_grid, s.grid, false, NW, lane);
        const int trials2 = static_cast<int8_t>(can ? trials - 1 : trials);
        n_trials = trials2;
        n_term = trials2 == 0 ? 1 : ((can && match) ? 1 : term);
      }
      break;
    }
    default: {  // NOOP
      copy_row<V>(o_grid, s.grid, false, NW, lane);
      break;
    }
  }

  // ---- the grids this op left alone ----
  if (!obj_ok) {
    copy_row<V>(p.o_selected + gbase, p.selected + gbase, sub_ros || rs, NW,
                lane);
    copy_row<V>(p.o_object + gbase, p.object + gbase, sub_ros, NW, lane);
    copy_row<V>(p.o_object_sel + gbase, p.object_sel + gbase, sub_ros, NW,
                lane);
    copy_row<V>(p.o_background + gbase, p.background + gbase, sub_ros, NW,
                lane);
  }
  if (!copy_ok)
    copy_row<V>(p.o_clip + gbase, grp == PASTE ? s.aux0 : p.clip + gbase,
                sub_ros, NW, lane);

  // ---- scalars and the epilogue ----
  if (lane == 0) {
    p.o_grid_dim[d] = static_cast<int8_t>(n_gh);
    p.o_grid_dim[d + 1] = static_cast<int8_t>(n_gw);
    p.o_clip_dim[d] = static_cast<int8_t>(n_ch);
    p.o_clip_dim[d + 1] = static_cast<int8_t>(n_cw);
    p.o_object_dim[d] = static_cast<int8_t>(n_oh);
    p.o_object_dim[d + 1] = static_cast<int8_t>(n_ow);
    p.o_object_pos[d] = static_cast<int8_t>(n_ox);
    p.o_object_pos[d + 1] = static_cast<int8_t>(n_oy);
    p.o_active[env] = static_cast<int8_t>(n_active);
    p.o_rotation_parity[env] = static_cast<int8_t>(n_parity);
    p.o_trials_remain[env] = static_cast<int8_t>(n_trials);
    p.o_terminated[env] = static_cast<int8_t>(n_term);
    p.o_submit_count[env] = submits0 + submitted;
    p.o_steps[env] = steps0 + 1;
    p.o_last_action_op[env] = op;
    const float reward = (op == p.submit_op && reward_match) ? 1.0f : 0.0f;
    p.o_reward[env] = reward;
    p.o_term[env] = static_cast<int8_t>(n_term) != 0;
    p.o_pending[env] = false;
  }
}

template <int H_, int W_, int V>
int launch(const Params& p, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {      // all of the SM's shared memory for 8 blocks
    const cudaError_t err = cudaFuncSetAttribute(
        step_kernel<H_, W_, V>, cudaFuncAttributePreferredSharedMemoryCarveout,
        static_cast<int>(cudaSharedmemCarveoutMaxShared));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int blocks = (p.B + kEnvsPerBlock - 1) / kEnvsPerBlock;
  step_kernel<H_, W_, V><<<blocks, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int H_, int W_, int V>
int resident_warps() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, step_kernel<H_, W_, V>, kThreads, 0) != cudaSuccess)
    return -1;
  return blocks * kEnvsPerBlock;
}

// ---------------------------------------------------------------------------
// The engine epilogue: everything envs/core.py::BatchedEnv.step does after the
// step kernel, in one launch.
//
// It replaces no TPU kernel: the JAX package leaves this tail to XLA's fusion
// of its jitted step.  The port ran it as about 85 small PyTorch calls a step
// (BatchedEnv.plain_epilogue, which stays as its plain version and its spec):
// reward shaping (the dense CustomO2ARCEnv reward or the paper's pixel
// reward), terminate-on-match, truncation at the episode limit, and the
// auto-reset merge of fresh rows, from the reset pool or drawn this step,
// into every field, with the pool counter's update.  It computes what the
// plain version computes, bit for bit: the float32 rewards are written with
// __fmul_rn / __fsub_rn / __fdiv_rn / __fadd_rn in the plain code's order,
// so nvcc contracts nothing into an FMA, and counts and penalties are int32.
//
// What bounds it on an H100: bytes.  A live env copies its 8 post-step grids
// into the carried state (900 bytes each at 30x30) and reads grid and answer
// once more, from cache, for the reward's counts: about 7.2 KB read and 7.2
// KB written per env, some 59 MB per launch at B=4096, about 18 us at 3.35
// TB/s.  A done env reads its fresh grid and answer instead.  The arithmetic
// is a compare and two adds per cell.
//
// Design.  One warp per env, as in the step kernel: an env's done flag, and
// so every branch, is uniform across its warp, and the two counts are warp
// reductions.  Neighbouring lanes move neighbouring 4-byte words (a 900-byte
// row starts on a 4-byte boundary only), through copy_row, so each lane has
// its whole share of a row in flight before it stores any.  B=4096 envs are
// resident at once on the 132 SMs, about 3.7 MB in flight, more than the
// HBM's latency asks for.  Fresh rows are read only for the envs that are
// done, and the scalars are spread over lanes.  Geometry is the step
// kernel's: 30x30 and 5x5 with constant H and W, any other H*W <= 1024 with
// runtime H, W.

struct EpiParams {
  // the post-step state: grids [B, P] in the order of Params' grids (grid,
  // input, answer, selected, clip, object, object_sel, background), dims
  // (grid_dim, input_dim, answer_dim, clip_dim, object_dim, object_pos),
  // flags (trials_remain, terminated, active, rotation_parity,
  // reset_on_submit), counts (steps, submit_count, last_action_op)
  const int8_t* grid[8];
  const int8_t* dim[6];
  int8_t* flag[5];                 // terminated is written back on a match
  const int32_t* count[3];
  const float* last_reward;
  const float* reward;             // the sparse reward
  const bool* term;
  // fresh rows: [B*K, P] pool rows (K > 0), or one drawn row per env (K = 0)
  const int8_t* f_grid; const int8_t* f_dim;
  const int8_t* f_answer; const int8_t* f_answer_dim;
  const int32_t* counter;          // [B], K > 0
  const int8_t* ros;               // a fresh row's reset_on_submit: [B] or []
  // outputs: the carried state, the new counter, reward, term, trunc
  int8_t* o_grid[8];
  int8_t* o_dim[6];
  int8_t* o_flag[5];
  int32_t* o_count[3];
  int32_t* o_counter;
  float* o_last_reward;
  float* o_reward; bool* o_term; bool* o_trunc;
  int B, H, W, K, dense, pixel, match, auto_reset, episode_limit, max_trial,
      ros_stride;
};

template <int H_, int W_, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
engine_epilogue(const EpiParams p) {
  using T = typename Word<V>::T;
  const int lane = threadIdx.x & 31;
  const int env = blockIdx.x * kEnvsPerBlock + (threadIdx.x >> 5);
  if (env >= p.B) return;                 // the ragged last block
  const int H = H_ ? H_ : p.H, W = H_ ? W_ : p.W, P = H * W;
  const int NW = P / V;
  const size_t gbase = static_cast<size_t>(env) * P;
  const int d = 2 * env;
  const int gh = p.dim[0][d], gw = p.dim[0][d + 1];
  const int ah = p.dim[2][d], aw = p.dim[2][d + 1];
  const int minh = min(gh, ah), minw = min(gw, aw);

  // ---- the counts the rewards and the match read: one pass ----
  // correct: equal cells inside both dims (dense_reward); wrong: differing
  // cells inside the answer's dims (pixel_reward, answers_match_any)
  int correct = 0, wrong = 0;
  if (p.dense || p.pixel || p.match) {
    const int8_t* g = p.grid[0] + gbase;
    const int8_t* a = p.grid[2] + gbase;
    for (int w = lane; w < NW; w += 32) {
      const T gv = ldw<V>(g, w), av = ldw<V>(a, w);
#pragma unroll
      for (int b = 0; b < V; ++b) {
        const int c = w * V + b, r = c / W, col = c - r * W;
        const bool same = cell<V>(gv, b) == cell<V>(av, b);
        correct += (r < minh && col < minw && same) ? 1 : 0;
        wrong += (r < ah && col < aw && !same) ? 1 : 0;
      }
    }
    correct = __reduce_add_sync(kFull, correct);
    wrong = __reduce_add_sync(kFull, wrong);
  }

  // ---- reward, termination, truncation ----
  float reward = p.reward[env];
  if (p.pixel) {                          // -(wrong / max(ah * aw, 1))
    reward = -__fdiv_rn(__int2float_rn(wrong),
                        __int2float_rn(max(ah * aw, 1)));
  } else if (p.dense) {                   // 100 sparse - 1 + correct / total
    const bool both = (gh <= ah) == (gw <= aw);
    const int pen = both ? abs(ah * aw - gh * gw)
                         : abs(gh - ah) * minw + abs(gw - aw) * minh;
    const float total = __fadd_rn(__int2float_rn(minh * minw),
                                  __int2float_rn(pen));
    reward = __fadd_rn(__fsub_rn(__fmul_rn(reward, 100.0f), 1.0f),
                       __fdiv_rn(__int2float_rn(correct), total));
  }
  int terminated = p.flag[1][env];
  bool term = p.term[env];
  if (p.match) {                          // max(terminated, solved)
    const bool solved = gh == ah && gw == aw && wrong == 0;
    terminated = max(terminated, solved ? 1 : 0);
    term = terminated != 0;
  }
  const bool trunc = p.episode_limit > 0 && p.count[0][env] >= p.episode_limit;
  if (lane == 0) {
    p.o_reward[env] = reward;
    p.o_term[env] = term;
    p.o_trunc[env] = trunc;
    // in place: the step kernel's fresh output, which `obs` carries
    if (p.match) p.flag[1][env] = static_cast<int8_t>(terminated);
  }
  if (!p.auto_reset) return;

  // ---- the carried state: the post-step row, or a fresh one ----
  const bool done = term || trunc;
  const int cnt = p.K ? p.counter[env] : 0;
  if (lane == 0 && p.K)
    p.o_counter[env] = static_cast<int32_t>(static_cast<uint32_t>(cnt) +
                                            (done ? 1u : 0u));
  const size_t row = p.K ? static_cast<size_t>(env) * p.K + floormod(cnt, p.K)
                         : static_cast<size_t>(env);
  int fh = 0, fw = 0;
  if (done) {
    fh = p.f_dim[2 * row];
    fw = p.f_dim[2 * row + 1];
    // grid and input: the fresh grid, masked to its dims where it was drawn
    // this step (init_state); a pool row was masked when the pool was made
    const int8_t* fg = p.f_grid + row * P;
    const bool mask = p.K == 0;
    for (int w = lane; w < NW; w += 32) {
      T v = ldw<V>(fg, w);
      if (mask) {
        T m = 0;
#pragma unroll
        for (int b = 0; b < V; ++b) {
          const int c = w * V + b, r = c / W, col = c - r * W;
          if (r < fh && col < fw) m = put<V>(m, b, cell<V>(v, b));
        }
        v = m;
      }
      stw<V>(p.o_grid[0] + gbase, w, v);
      stw<V>(p.o_grid[1] + gbase, w, v);
    }
    copy_row<V>(p.o_grid[2] + gbase, p.f_answer + row * P, false, NW, lane);
#pragma unroll
    for (int k = 3; k < 8; ++k)
      copy_row<V>(p.o_grid[k] + gbase, nullptr, true, NW, lane);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      copy_row<V>(p.o_grid[k] + gbase, p.grid[k] + gbase, false, NW, lane);
  }

  // scalars, one field a lane: dims on lanes 0-5, flags on 6-10, counts on
  // 11-13, last_reward on 14; a fresh row is init_state's
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    if (lane != k) continue;
    int8_t v0 = 0, v1 = 0;
    if (!done) {
      v0 = p.dim[k][d]; v1 = p.dim[k][d + 1];
    } else if (k <= 1) {                  // grid_dim, input_dim
      v0 = static_cast<int8_t>(fh); v1 = static_cast<int8_t>(fw);
    } else if (k == 2) {                  // answer_dim
      v0 = p.f_answer_dim[2 * row]; v1 = p.f_answer_dim[2 * row + 1];
    }
    p.o_dim[k][d] = v0;
    p.o_dim[k][d + 1] = v1;
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    if (lane != 6 + k) continue;
    int8_t v = 0;
    if (!done) {
      v = k == 1 ? static_cast<int8_t>(terminated) : p.flag[k][env];
    } else if (k == 0) {                  // trials_remain
      v = static_cast<int8_t>(p.max_trial);
    } else if (k == 4) {                  // reset_on_submit
      v = p.ros[static_cast<size_t>(env) * p.ros_stride];
    }
    p.o_flag[k][env] = v;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (lane != 11 + k) continue;
    p.o_count[k][env] = done ? (k == 2 ? -1 : 0) : p.count[k][env];
  }
  if (lane == 14) p.o_last_reward[env] = done ? 0.0f : p.last_reward[env];
}

template <int H_, int W_, int V>
int launch_epilogue(const EpiParams& p, cudaStream_t stream) {
  const int blocks = (p.B + kEnvsPerBlock - 1) / kEnvsPerBlock;
  engine_epilogue<H_, W_, V><<<blocks, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Warps (envs) of the instantiation for H x W that one SM holds at once,
// or -1 on error.
extern "C" int arcle_step_resident_warps(int H, int W) {
  if (H == 30 && W == 30) return resident_warps<30, 30, 4>();
  if (H == 5 && W == 5) return resident_warps<5, 5, 1>();
  return resident_warps<0, 0, 1>();
}

// Plain C entry point.  `in` is a host array of the 24 input device pointers
// in the order of Params; the 20 outputs lie in one device arena at `out`,
// output k at byte offset out_offsets[k], in the order of Params.  At 30x30
// the grids must start on 4-byte boundaries.  Launches on `stream` and
// returns cudaGetLastError() of the launch.
extern "C" int arcle_step_launch(const void* const* in, void* out,
                                 const int64_t* out_offsets, int B, int H,
                                 int W, int n_ops, int max_trial,
                                 int submit_op, void* stream) {
  Params p;
  const int8_t* const* i8 = reinterpret_cast<const int8_t* const*>(in);
  p.grid = i8[0]; p.input = i8[1]; p.answer = i8[2]; p.selected = i8[3];
  p.clip = i8[4]; p.object = i8[5]; p.object_sel = i8[6];
  p.background = i8[7]; p.selection = i8[8];
  p.grid_dim = i8[9]; p.input_dim = i8[10]; p.answer_dim = i8[11];
  p.clip_dim = i8[12]; p.object_dim = i8[13]; p.object_pos = i8[14];
  p.trials_remain = i8[15]; p.terminated = i8[16]; p.active = i8[17];
  p.rotation_parity = i8[18]; p.reset_on_submit = i8[19];
  p.steps = static_cast<const int32_t*>(in[20]);
  p.submit_count = static_cast<const int32_t*>(in[21]);
  p.operation = static_cast<const int32_t*>(in[22]);
  p.table = static_cast<const int32_t*>(in[23]);

  int8_t* base = static_cast<int8_t*>(out);
  int8_t* o[20];
  for (int k = 0; k < 20; ++k) o[k] = base + out_offsets[k];
  p.o_grid = o[0]; p.o_selected = o[1]; p.o_clip = o[2];
  p.o_object = o[3]; p.o_object_sel = o[4]; p.o_background = o[5];
  p.o_grid_dim = o[6]; p.o_clip_dim = o[7]; p.o_object_dim = o[8];
  p.o_object_pos = o[9];
  p.o_trials_remain = o[10]; p.o_terminated = o[11]; p.o_active = o[12];
  p.o_rotation_parity = o[13];
  p.o_steps = reinterpret_cast<int32_t*>(o[14]);
  p.o_submit_count = reinterpret_cast<int32_t*>(o[15]);
  p.o_last_action_op = reinterpret_cast<int32_t*>(o[16]);
  p.o_reward = reinterpret_cast<float*>(o[17]);
  p.o_term = reinterpret_cast<bool*>(o[18]);
  p.o_pending = reinterpret_cast<bool*>(o[19]);

  p.B = B; p.H = H; p.W = W; p.n_ops = n_ops;
  p.max_trial = max_trial; p.submit_op = submit_op;

  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 30 && W == 30) return launch<30, 30, 4>(p, s);
  if (H == 5 && W == 5) return launch<5, 5, 1>(p, s);
  return launch<0, 0, 1>(p, s);
}

// Plain C entry point of the engine epilogue.  `in` is a host array of 31
// device pointers: the post-step state's 8 grids, 6 dims, 5 flags, 3 counts
// and last_reward in the order of EpiParams, then the sparse reward, term,
// the fresh grid, dim, answer and answer_dim, the pool counter (unused when
// K = 0) and the reset_on_submit row (`ros_stride` 0 for a scalar).  The 27
// outputs lie in one device arena at `out`, output k at byte offset
// out_offsets[k]: the carried state's 23 fields in the same order with the
// new counter after the counts, then reward, term and trunc; with
// auto_reset = 0 only the last three are written.  At 30x30 the grids must
// start on 4-byte boundaries.  Launches on `stream` and returns
// cudaGetLastError() of the launch.
extern "C" int arcle_epilogue_launch(const void* const* in, void* out,
                                     const int64_t* out_offsets, int B, int H,
                                     int W, int K, int dense, int pixel,
                                     int match, int auto_reset,
                                     int episode_limit, int max_trial,
                                     int ros_stride, void* stream) {
  EpiParams p;
  const int8_t* const* i8 = reinterpret_cast<const int8_t* const*>(in);
  for (int k = 0; k < 8; ++k) p.grid[k] = i8[k];
  for (int k = 0; k < 6; ++k) p.dim[k] = i8[8 + k];
  for (int k = 0; k < 5; ++k) p.flag[k] = const_cast<int8_t*>(i8[14 + k]);
  for (int k = 0; k < 3; ++k)
    p.count[k] = static_cast<const int32_t*>(in[19 + k]);
  p.last_reward = static_cast<const float*>(in[22]);
  p.reward = static_cast<const float*>(in[23]);
  p.term = static_cast<const bool*>(in[24]);
  p.f_grid = i8[25]; p.f_dim = i8[26];
  p.f_answer = i8[27]; p.f_answer_dim = i8[28];
  p.counter = static_cast<const int32_t*>(in[29]);
  p.ros = i8[30];

  int8_t* base = static_cast<int8_t*>(out);
  int8_t* o[27];
  for (int k = 0; k < 27; ++k) o[k] = base + out_offsets[k];
  for (int k = 0; k < 8; ++k) p.o_grid[k] = o[k];
  for (int k = 0; k < 6; ++k) p.o_dim[k] = o[8 + k];
  for (int k = 0; k < 5; ++k) p.o_flag[k] = o[14 + k];
  for (int k = 0; k < 3; ++k) p.o_count[k] = reinterpret_cast<int32_t*>(o[19 + k]);
  p.o_counter = reinterpret_cast<int32_t*>(o[22]);
  p.o_last_reward = reinterpret_cast<float*>(o[23]);
  p.o_reward = reinterpret_cast<float*>(o[24]);
  p.o_term = reinterpret_cast<bool*>(o[25]);
  p.o_trunc = reinterpret_cast<bool*>(o[26]);

  p.B = B; p.H = H; p.W = W; p.K = K; p.dense = dense; p.pixel = pixel;
  p.match = match; p.auto_reset = auto_reset;
  p.episode_limit = episode_limit; p.max_trial = max_trial;
  p.ros_stride = ros_stride;

  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 30 && W == 30) return launch_epilogue<30, 30, 4>(p, s);
  if (H == 5 && W == 5) return launch_epilogue<5, 5, 1>(p, s);
  return launch_epilogue<0, 0, 1>(p, s);
}

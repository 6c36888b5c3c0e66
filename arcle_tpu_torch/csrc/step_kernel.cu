// One whole O2ARC / ARC / Raw env transition per thread block, for Hopper.
//
// Replaces the TPU Pallas megakernel arcle_tpu/ops/pallas_step.py::_step_kernel
// (launched through pl.pallas_call in _step_impl).  It computes what the JAX
// package's XLA path computes (arcle_tpu/ops/table.py::step_deferred followed
// by finish_flood), bit for bit, and folds the reward / bookkeeping epilogue
// in: steps, last_action_op, last_reward, submit_count, terminated.
//
// Design.  One block of 256 threads owns one env; each thread owns the cells
// tid, tid+256, tid+512, tid+768 of the flat [H*W] grid (H*W <= 1024).  The
// op, and so the group, is uniform across the block, so the block runs only
// the branch of its env's group instead of every candidate.  The grid and the
// selection sit in shared memory, together with the scratch buffers of the
// object transform and the flood mask (about 8 KB).
//   * Selection reductions (any, total, bbox, argmax) are warp reductions
//     (__reduce_*_sync) followed by one pass over the 8 warps' partials.
//   * Placements are direct index arithmetic: the value at (r, c) is
//     patch[(r - x) mod H][(c - y) mod W] inside the window.  rot90 / rot270 /
//     flipH / flipV / transposes are index maps followed by the re-anchor
//     roll, reproducing the JAX package's whole 30x30 buffer (not only the
//     window).  No matmuls, no permutation matrices.
//   * FLOOD finishes the component exactly: a 4-neighbour relaxation in shared
//     memory repeated until __syncthreads_or reports no change, so `pending`
//     is always false and no batch-level fix-up follows on the GPU.
//   * All arithmetic on int8 state is done in int and cast to int8 on the
//     store (wraparound as in the reference); floor division and modulo of
//     possibly negative values go through floordiv / floormod.
//
// What bounds it on an H100.  Each env-step reads 9 int8 grids and writes 6
// (about 13.5 KB at 30x30) plus a few dozen bytes of scalars: at B=4096 that
// is about 55 MB, some 17 us at 3.35 TB/s.  The work per cell is a handful of
// integer operations.  So the kernel is bound by latency (the barriers of the
// reductions and, for flood fills, of the relaxation loop) and by launch
// overhead, not by bandwidth or arithmetic.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared library
// with a plain C interface (ops/step_kernel.py loads it with ctypes).

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCells = 1024;
constexpr int kCellsPerThread = kMaxCells / kThreads;

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
  // static facts.  Per-group facts of the table (has flood, object kinds)
  // need no flags: each block branches on its own env's group.
  int H, W, n_ops, max_trial, submit_op;
};

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int floormod(int a, int b) {
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// Block-wide reductions.  Every thread gets the result.  `scratch` holds
// kWarps ints; the trailing barrier lets the caller reuse it at once.
__device__ __forceinline__ int block_min(int v, int* scratch) {
  v = __reduce_min_sync(0xffffffffu, v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int r = lane < kWarps ? scratch[lane] : INT_MAX;
  r = __reduce_min_sync(0xffffffffu, r);
  __syncthreads();
  return r;
}

__device__ __forceinline__ int block_max(int v, int* scratch) {
  v = __reduce_max_sync(0xffffffffu, v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int r = lane < kWarps ? scratch[lane] : INT_MIN;
  r = __reduce_max_sync(0xffffffffu, r);
  __syncthreads();
  return r;
}

__device__ __forceinline__ int block_sum(int v, int* scratch) {
  v = __reduce_add_sync(0xffffffffu, v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int r = lane < kWarps ? scratch[lane] : 0;
  r = __reduce_add_sync(0xffffffffu, r);
  __syncthreads();
  return r;
}

// Source cell of the object transform `kind` for output cell (i, j) of a
// square H x W buffer whose patch is h x w (pre-transform dims).  Matches
// arcle_tpu/ops/groups.py::_transform_buffer: the jnp rot90 / flip followed
// by a roll of (w - W) or (h - H) along one axis.
__device__ __forceinline__ int transform_src(int kind, int i, int j, int h,
                                             int w, int H, int W) {
  switch (kind) {
    case ROT_90:   // R[i][j] = buf[j][W-1-i], rolled by w-W along rows
      return j * W + (W - 1 - floormod(i - (w - W), H));
    case ROT_270:  // R[i][j] = buf[H-1-j][i], rolled by h-H along columns
      return (H - 1 - floormod(j - (h - H), W)) * W + i;
    case FLIP_H:   // buf[i][W-1-j], rolled by w-W along columns
      return i * W + (W - 1 - floormod(j - (w - W), W));
    case FLIP_V:   // buf[H-1-i][j], rolled by h-H along rows
      return (H - 1 - floormod(i - (h - H), H)) * W + j;
    case FLIP_D0:  // transpose
      return j * W + i;
    case FLIP_D1: {  // rot180 then transpose, rolled by w-W (rows), h-H (cols)
      const int a = floormod(i - (w - W), H), c = floormod(j - (h - H), W);
      return (H - 1 - c) * W + (W - 1 - a);
    }
    default:       // moves keep the buffer
      return i * W + j;
  }
}

__global__ void __launch_bounds__(kThreads)
step_kernel(const Params p) {
  __shared__ int8_t s_grid[kMaxCells];
  __shared__ int8_t s_sel[kMaxCells];
  __shared__ int8_t s_buf_a[kMaxCells];   // object buffer (pre-transform)
  __shared__ int8_t s_buf_b[kMaxCells];   // object_sel buffer (pre-transform)
  __shared__ int8_t s_buf_c[kMaxCells];   // object buffer (transformed)
  __shared__ int8_t s_buf_d[kMaxCells];   // object_sel buffer (transformed)
  __shared__ int8_t s_flood[kMaxCells];
  __shared__ int s_red[kWarps];

  const int env = blockIdx.x;
  const int tid = threadIdx.x;
  const int H = p.H, W = p.W, P = H * W;
  const size_t gbase = static_cast<size_t>(env) * P;
  const int d = 2 * env;

  // ---- per-env scalars and the op-table lookup ----
  int op = p.operation[env];
  op = op < 0 ? 0 : (op > p.n_ops - 1 ? p.n_ops - 1 : op);
  const int grp = p.table[op];
  const int par = p.table[p.n_ops + op];
  const int rs = p.table[2 * p.n_ops + op];

  const int gh = p.grid_dim[d], gw = p.grid_dim[d + 1];
  const int ih = p.input_dim[d], iw = p.input_dim[d + 1];
  const int ah = p.answer_dim[d], aw = p.answer_dim[d + 1];
  const int ch = p.clip_dim[d], cw = p.clip_dim[d + 1];
  const int oh = p.object_dim[d], ow = p.object_dim[d + 1];
  const int ox = p.object_pos[d], oy = p.object_pos[d + 1];
  const int trials = p.trials_remain[env];
  const int term = p.terminated[env];
  const int active0 = rs ? 0 : p.active[env];   // reset_sel decorator
  const int parity = p.rotation_parity[env];
  const int ros = p.reset_on_submit[env];

  // ---- stage the grid and the selection; selection reductions ----
  int any = 0, total = 0, maxv = INT_MIN;
  int rmin = INT_MAX, rmax = -1, cmin = INT_MAX, cmax = -1;
  for (int k = 0; k < kCellsPerThread; ++k) {
    const int c = tid + k * kThreads;
    if (c >= P) break;
    const int8_t gv = p.grid[gbase + c];
    const int8_t sv = p.selection[gbase + c];
    s_grid[c] = gv;
    s_sel[c] = sv;
    total += sv;
    maxv = max(maxv, static_cast<int>(sv));
    if (sv != 0) {
      const int r = c / W, col = c - r * W;
      any = 1;
      rmin = min(rmin, r); rmax = max(rmax, r);
      cmin = min(cmin, col); cmax = max(cmax, col);
    }
  }
  any = block_max(any, s_red);
  total = block_sum(total, s_red);
  maxv = block_max(maxv, s_red);
  rmin = block_min(rmin, s_red);
  rmax = block_max(rmax, s_red);
  cmin = block_min(cmin, s_red);
  cmax = block_max(cmax, s_red);
  if (!any) { rmin = rmax = cmin = cmax = 0; }
  const int h_s = rmax - rmin + 1, w_s = cmax - cmin + 1;
  // (the barriers inside the reductions also publish s_grid / s_sel)

  // Selection-shifted views: the grid / selection / input with the bbox
  // corner moved to the origin (jnp roll semantics, so mod H / mod W).
  auto shifted = [&](int c) {
    const int r = c / W, col = c - r * W;
    return floormod(r + rmin, H) * W + floormod(col + cmin, W);
  };
  auto in_sel_window = [&](int c) {
    const int r = c / W, col = c - r * W;
    return r < h_s && col < w_s && s_sel[shifted(c)] != 0;
  };

  // outputs defaulting to the (decorated) pre-op state
  int n_gh = gh, n_gw = gw, n_ch = ch, n_cw = cw;
  int n_oh = oh, n_ow = ow, n_ox = ox, n_oy = oy;
  int n_active = active0, n_parity = parity;
  int n_trials = trials, n_term = term, submitted = 0, reward_match = 0;
  // which grids besides `grid` this op replaces (block-uniform)
  bool obj_ok = false, sub_ros = false, copy_ok = false;
  int8_t* o_grid = p.o_grid + gbase;

  switch (grp) {
    case COLOR: {
      const int8_t v = static_cast<int8_t>(par);
      for (int c = tid; c < P; c += kThreads)
        o_grid[c] = s_sel[c] != 0 ? v : s_grid[c];
      break;
    }
    case FLOOD: {
      // seed: the first cell holding the selection's max (jnp.argmax)
      int idx = INT_MAX;
      for (int c = tid; c < P; c += kThreads)
        if (s_sel[c] == maxv) idx = min(idx, c);
      idx = block_min(idx, s_red);
      const int px = idx / W, py = idx - px * W;
      const bool valid = total == 1 && px < gh && py < gw;
      if (!valid) {
        for (int c = tid; c < P; c += kThreads) o_grid[c] = s_grid[c];
        break;
      }
      const int8_t seed_color = s_grid[idx];
      bool region[kCellsPerThread];
      for (int k = 0; k < kCellsPerThread; ++k) {
        const int c = tid + k * kThreads;
        region[k] = false;
        if (c < P) {
          const int r = c / W, col = c - r * W;
          region[k] = s_grid[c] == seed_color && r < gh && col < gw;
          s_flood[c] = (c == idx && region[k]) ? 1 : 0;
        }
      }
      __syncthreads();
      // relax until the component stops growing (exact; no pending)
      volatile int8_t* fl = s_flood;
      for (;;) {
        int changed = 0;
        for (int k = 0; k < kCellsPerThread; ++k) {
          const int c = tid + k * kThreads;
          if (c >= P || !region[k] || fl[c]) continue;
          const int r = c / W, col = c - r * W;
          if ((r > 0 && fl[c - W]) || (r < H - 1 && fl[c + W]) ||
              (col > 0 && fl[c - 1]) || (col < W - 1 && fl[c + 1])) {
            fl[c] = 1;
            changed = 1;
          }
        }
        if (!__syncthreads_or(changed)) break;
      }
      const int8_t v = static_cast<int8_t>(par);
      for (int c = tid; c < P; c += kThreads)
        o_grid[c] = s_flood[c] ? v : s_grid[c];
      break;
    }
    case OBJECT: {
      const bool has_sel = any != 0;
      obj_ok = has_sel || active0 != 0;
      if (!obj_ok) {
        for (int c = tid; c < P; c += kThreads) o_grid[c] = s_grid[c];
        break;
      }
      // _init_objsel: the buffers from the selection, or the stored ones
      for (int c = tid; c < P; c += kThreads) {
        if (has_sel) {
          const bool in = in_sel_window(c);
          s_buf_a[c] = in ? s_grid[shifted(c)] : 0;
          s_buf_b[c] = in ? 1 : 0;
        } else {
          s_buf_a[c] = p.object[gbase + c];
          s_buf_b[c] = p.object_sel[gbase + c];
        }
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
      __syncthreads();
      for (int c = tid; c < P; c += kThreads) {
        const int i = c / W, j = c - i * W;
        const int src = transform_src(kind, i, j, h, w, H, W);
        s_buf_c[c] = s_buf_a[src];
        s_buf_d[c] = s_buf_b[src];
      }
      __syncthreads();
      // _apply_patch / _apply_sel: place the transformed buffers at (x2, y2)
      for (int c = tid; c < P; c += kThreads) {
        const int i = c / W, j = c - i * W;
        const bool win = i >= x2 && i < x2 + h2 && j >= y2 && j < y2 + w2 &&
                         i < gh && j < gw;
        const int src = floormod(i - x2, H) * W + floormod(j - y2, W);
        const int8_t vals = s_buf_c[src];
        const int8_t bg = has_sel ? (s_sel[c] != 0 ? 0 : s_grid[c])
                                  : p.background[gbase + c];
        o_grid[c] = (win && vals != 0) ? vals : bg;
        p.o_selected[gbase + c] = win ? s_buf_d[src] : 0;
        p.o_object[gbase + c] = s_buf_c[c];
        p.o_object_sel[gbase + c] = s_buf_d[c];
        p.o_background[gbase + c] = bg;
      }
      n_ox = x2; n_oy = y2; n_oh = h2; n_ow = w2;
      n_active = 1;
      n_parity = is_rot ? par_rot : par0;
      break;
    }
    case COPY: {
      const bool from_input = par == 0;
      const int src_h = from_input ? ih : gh, src_w = from_input ? iw : gw;
      // strictly-greater bound, as in the reference (object.py:301)
      copy_ok = any && !(rmax > src_h || cmax > src_w);
      for (int c = tid; c < P; c += kThreads) {
        o_grid[c] = s_grid[c];
        if (copy_ok) {
          const int sc = shifted(c);
          const int8_t src = from_input ? p.input[gbase + sc] : s_grid[sc];
          p.o_clip[gbase + c] = (in_sel_window(c) && src != 0) ? src : 0;
        }
      }
      if (copy_ok) { n_ch = h_s; n_cw = w_s; }
      break;
    }
    case PASTE: {
      const bool valid = any && ch != 0 && cw != 0;
      const bool blank = par != 0;
      for (int c = tid; c < P; c += kThreads) {
        const int i = c / W, j = c - i * W;
        int8_t out = s_grid[c];
        if (valid && i >= rmin && i < rmin + ch && j >= cmin &&
            j < cmin + cw) {
          const int8_t v =
              p.clip[gbase + floormod(i - rmin, H) * W + floormod(j - cmin, W)];
          if (blank || v != 0) out = v;
        }
        o_grid[c] = out;
      }
      break;
    }
    case COPY_FROM_INPUT: {
      for (int c = tid; c < P; c += kThreads) o_grid[c] = p.input[gbase + c];
      n_gh = ih; n_gw = iw;
      break;
    }
    case RESET_GRID: {
      for (int c = tid; c < P; c += kThreads) o_grid[c] = 0;
      break;
    }
    case RESIZE_GRID: {
      for (int c = tid; c < P; c += kThreads) o_grid[c] = any ? 0 : s_grid[c];
      if (any) { n_gh = h_s; n_gw = w_s; }
      break;
    }
    case CROP_GRID: {
      for (int c = tid; c < P; c += kThreads) {
        int8_t out = s_grid[c];
        if (any) {
          const int8_t v = s_grid[shifted(c)];
          out = (in_sel_window(c) && v != 0) ? v : 0;
        }
        o_grid[c] = out;
      }
      if (any) { n_gh = h_s; n_gw = w_s; }
      break;
    }
    case RESIZE_TO_ANSWER: {
      for (int c = tid; c < P; c += kThreads) {
        const int r = c / W, col = c - r * W;
        o_grid[c] = (r < ah && col < aw) ? s_grid[c] : 0;
      }
      n_gh = ah; n_gw = aw;
      break;
    }
    case SUBMIT: {
      // answers_match of the pre-op grid and of the fresh grid (the input)
      int wrong = 0, wrong_fresh = 0;
      for (int c = tid; c < P; c += kThreads) {
        const int r = c / W, col = c - r * W;
        if (r < ah && col < aw) {
          const int8_t a = p.answer[gbase + c];
          wrong |= s_grid[c] != a;
          wrong_fresh |= p.input[gbase + c] != a;
        }
      }
      wrong = __syncthreads_or(wrong);
      wrong_fresh = __syncthreads_or(wrong_fresh);
      const bool match = gh == ah && gw == aw && !wrong;
      const bool fresh_match = ih == ah && iw == aw && !wrong_fresh;
      const bool can = trials != 0;
      submitted = can;
      sub_ros = can && ros != 0;
      reward_match = sub_ros ? fresh_match : match;
      if (sub_ros) {
        // init_state: the grid is the input, zeroed outside input_dim
        for (int c = tid; c < P; c += kThreads) {
          const int r = c / W, col = c - r * W;
          o_grid[c] = (r < ih && col < iw) ? p.input[gbase + c] : 0;
        }
        n_gh = ih; n_gw = iw; n_ch = n_cw = 0;
        n_oh = n_ow = n_ox = n_oy = 0;
        n_active = 0; n_parity = 0;
        n_trials = p.max_trial; n_term = 0;
      } else {
        for (int c = tid; c < P; c += kThreads) o_grid[c] = s_grid[c];
        const int trials2 = static_cast<int8_t>(can ? trials - 1 : trials);
        n_trials = trials2;
        n_term = trials2 == 0 ? 1 : ((can && match) ? 1 : term);
      }
      break;
    }
    default: {  // NOOP
      for (int c = tid; c < P; c += kThreads) o_grid[c] = s_grid[c];
      break;
    }
  }

  // ---- the grids this op left alone ----
  for (int c = tid; c < P; c += kThreads) {
    const size_t g = gbase + c;
    if (!obj_ok) {
      p.o_selected[g] = (sub_ros || rs) ? 0 : p.selected[g];
      p.o_object[g] = sub_ros ? 0 : p.object[g];
      p.o_object_sel[g] = sub_ros ? 0 : p.object_sel[g];
      p.o_background[g] = sub_ros ? 0 : p.background[g];
    }
    if (!copy_ok) p.o_clip[g] = sub_ros ? 0 : p.clip[g];
  }

  // ---- scalars and the epilogue ----
  if (tid == 0) {
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
    p.o_submit_count[env] = p.submit_count[env] + submitted;
    p.o_steps[env] = p.steps[env] + 1;
    p.o_last_action_op[env] = op;
    const float reward = (op == p.submit_op && reward_match) ? 1.0f : 0.0f;
    p.o_reward[env] = reward;
    p.o_term[env] = static_cast<int8_t>(n_term) != 0;
    p.o_pending[env] = false;
  }
}

}  // namespace

// Plain C entry point.  `in` and `out` are host arrays of device pointers in
// the order of Params (24 inputs, 20 outputs).  Launches on `stream` and
// returns cudaGetLastError() of the launch.
extern "C" int arcle_step_launch(const void* const* in, void* const* out,
                                 int B, int H, int W, int n_ops,
                                 int max_trial, int submit_op, void* stream) {
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

  int8_t* const* o8 = reinterpret_cast<int8_t* const*>(out);
  p.o_grid = o8[0]; p.o_selected = o8[1]; p.o_clip = o8[2];
  p.o_object = o8[3]; p.o_object_sel = o8[4]; p.o_background = o8[5];
  p.o_grid_dim = o8[6]; p.o_clip_dim = o8[7]; p.o_object_dim = o8[8];
  p.o_object_pos = o8[9];
  p.o_trials_remain = o8[10]; p.o_terminated = o8[11]; p.o_active = o8[12];
  p.o_rotation_parity = o8[13];
  p.o_steps = static_cast<int32_t*>(out[14]);
  p.o_submit_count = static_cast<int32_t*>(out[15]);
  p.o_last_action_op = static_cast<int32_t*>(out[16]);
  p.o_reward = static_cast<float*>(out[17]);
  p.o_term = static_cast<bool*>(out[18]);
  p.o_pending = static_cast<bool*>(out[19]);

  p.H = H; p.W = W; p.n_ops = n_ops;
  p.max_trial = max_trial; p.submit_op = submit_op;

  if (B > 0) {
    step_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// libvqadata — the host runtime of the vqatpu_torch data pipeline, a copy
// of the JAX package's native/vqadata.cc (the port builds and loads its
// own copy, never the JAX package's library).
//
// The Python data layer (vqatpu_torch/data/batching.py) assembles each
// batch by slicing ragged per-image region features (the adaptive
// `pos_boxes` layout, reference FFOE/dataset.py:350-357) and zero-padding
// to a static [B, max_boxes, dim] block.  At production batch sizes that
// gather+pad is host-bound Python/numpy; this library does it with a
// worker pool over a ticketed queue and a ring of output slots,
// overlapping batch assembly with the card's compute, and quantizes box
// rows to int8 in one pass per row.
//
// C ABI (consumed via ctypes from vqatpu_torch/data/native.py):
//   vqadata_store_create / _create_q8 / _destroy — register feature arrays
//   vqadata_assemble / _assemble_q8             — synchronous gather+pad
//   vqadata_loader_create / _create_multi / _next / _destroy — prefetch loop
//   vqadata_quantize_rows                       — per-row int8 quantizer
//
// Build: vqatpu_torch/data/native.py compiles it at first use with the host
// compiler into vqatpu_torch/_build/ (always with -ffp-contract=off, see
// quantize_row).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Store {
  const float* features;   // [total_boxes, v_dim] (adaptive) or [N, K, v_dim]
  const float* spatials;   // same layout, s_dim
  const int64_t* pos_boxes;  // [n_images, 2] or nullptr (fixed layout)
  int64_t n_images;
  int64_t fixed_boxes;  // K when pos_boxes == nullptr
  int64_t v_dim;
  int64_t s_dim;
  // int8-resident mode (FeatureStore.quantized): features live as q8 +
  // per-box-row scales; `features` is nullptr.  f32 assembly dequantizes,
  // q8 assembly memcpys (quantization is exactly idempotent).
  const int8_t* features_q = nullptr;
  const float* f_scales = nullptr;  // [total_boxes] / [N*K]
};

// One box row -> int8 + scale (the quantize_v contract: scale = absmax/127,
// all-zero rows scale 1, ROUND-HALF-EVEN — bit-identical to np.rint).
// Rounding uses the magic-number trick (adding 1.5*2^23 makes the FPU's
// nearest-even rounding materialize the integer in the low mantissa bits):
// a plain float add + int subtract, so -O3 auto-vectorizes the loop where
// the previous std::lrintf call compiled to a scalar libm call per element
// (~15x slower at v_dim 2048).
inline void quantize_row(const float* src, int64_t d, int8_t* dst,
                         float* scale_out) {
  float amax = 0.0f;
  for (int64_t k = 0; k < d; ++k) {
    // max-reduction form (not if-update) so -O3 vectorizes it
    amax = std::max(amax, std::fabs(src[k]));
  }
  const float sc = amax > 0.0f ? amax / 127.0f : 1.0f;
  *scale_out = sc;
  const float inv = 1.0f / sc;
  constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23; ulp = 1 around it
  int32_t magic_bits;
  std::memcpy(&magic_bits, &kMagic, 4);
  for (int64_t k = 0; k < d; ++k) {
    // src[k]*inv ∈ [-127, 127], so y stays in [2^23, 2^24) where
    // consecutive integers have consecutive bit patterns.  The product
    // MUST round to f32 before the magic add (an FMA keeps the exact
    // product and flips tie-adjacent roundings vs np.rint) — the build
    // compiles with -ffp-contract=off to guarantee it.
    const float p = src[k] * inv;
    const float y = p + kMagic;
    int32_t bits;
    std::memcpy(&bits, &y, 4);
    dst[k] = static_cast<int8_t>(bits - magic_bits);
  }
}

// One image's gather+pad into one output row (shared by the single-store
// range loops and the multi-store per-row dispatch below).
inline void assemble_one(const Store& s, int64_t img, int64_t max_boxes,
                         float* v_row, float* b_row, uint8_t* m_row) {
  int64_t start, count;
  if (s.pos_boxes != nullptr) {
    start = s.pos_boxes[2 * img];
    count = s.pos_boxes[2 * img + 1] - start;
  } else {
    start = img * s.fixed_boxes;
    count = s.fixed_boxes;
  }
  if (count > max_boxes) count = max_boxes;

  if (s.features_q != nullptr) {  // int8-resident store: dequantize
    for (int64_t box = 0; box < count; ++box) {
      const int8_t* src = s.features_q + (start + box) * s.v_dim;
      const float sc = s.f_scales[start + box];
      float* dst = v_row + box * s.v_dim;
      for (int64_t k = 0; k < s.v_dim; ++k)
        dst[k] = static_cast<float>(src[k]) * sc;
    }
  } else {
    std::memcpy(v_row, s.features + start * s.v_dim,
                count * s.v_dim * sizeof(float));
  }
  std::memset(v_row + count * s.v_dim, 0,
              (max_boxes - count) * s.v_dim * sizeof(float));
  std::memcpy(b_row, s.spatials + start * s.s_dim,
              count * s.s_dim * sizeof(float));
  std::memset(b_row + count * s.s_dim, 0,
              (max_boxes - count) * s.s_dim * sizeof(float));
  std::memset(m_row, 1, count);
  std::memset(m_row + count, 0, max_boxes - count);
}

void assemble_range(const Store& s, const int64_t* image_idx, int64_t lo,
                    int64_t hi, int64_t max_boxes, float* out_v, float* out_b,
                    uint8_t* out_mask) {
  for (int64_t i = lo; i < hi; ++i) {
    assemble_one(s, image_idx[i], max_boxes, out_v + i * max_boxes * s.v_dim,
                 out_b + i * max_boxes * s.s_dim, out_mask + i * max_boxes);
  }
}

// int8 variant of assemble_range for the transfer_dtype="int8" wire: each
// box row is quantized straight OUT OF THE STORE (scale = absmax/127, q =
// rint(v/scale) — the steps.quantize_v contract) so the f32 slab is never
// materialized; the quantized path writes 4x FEWER bytes than f32
// assembly.  Padded boxes emit q=0, scale=1.
inline void assemble_one_q8(const Store& s, int64_t img, int64_t max_boxes,
                            int8_t* v_row, float* sc_row, float* b_row,
                            uint8_t* m_row) {
  int64_t start, count;
  if (s.pos_boxes != nullptr) {
    start = s.pos_boxes[2 * img];
    count = s.pos_boxes[2 * img + 1] - start;
  } else {
    start = img * s.fixed_boxes;
    count = s.fixed_boxes;
  }
  if (count > max_boxes) count = max_boxes;

  if (s.features_q != nullptr) {
    // int8-resident store: the rows ARE the wire bytes — pure memcpy
    std::memcpy(v_row, s.features_q + start * s.v_dim, count * s.v_dim);
    std::memcpy(sc_row, s.f_scales + start, count * sizeof(float));
  } else {
    for (int64_t box = 0; box < count; ++box) {
      quantize_row(s.features + (start + box) * s.v_dim, s.v_dim,
                   v_row + box * s.v_dim, sc_row + box);
    }
  }
  std::memset(v_row + count * s.v_dim, 0, (max_boxes - count) * s.v_dim);
  std::fill(sc_row + count, sc_row + max_boxes, 1.0f);
  std::memcpy(b_row, s.spatials + start * s.s_dim,
              count * s.s_dim * sizeof(float));
  std::memset(b_row + count * s.s_dim, 0,
              (max_boxes - count) * s.s_dim * sizeof(float));
  std::memset(m_row, 1, count);
  std::memset(m_row + count, 0, max_boxes - count);
}

void assemble_range_q8(const Store& s, const int64_t* image_idx, int64_t lo,
                       int64_t hi, int64_t max_boxes, int8_t* out_v,
                       float* out_scale, float* out_b, uint8_t* out_mask) {
  for (int64_t i = lo; i < hi; ++i) {
    assemble_one_q8(s, image_idx[i], max_boxes,
                    out_v + i * max_boxes * s.v_dim, out_scale + i * max_boxes,
                    out_b + i * max_boxes * s.s_dim, out_mask + i * max_boxes);
  }
}

// A ring slot: caller-registered output buffers the worker assembles
// DIRECTLY into (zero-copy hand-off; the old slab->caller memcpy cost
// ~24 ms/batch at [256, 50, 2048] on a 1-core host).  A slot's contents
// are valid from the time loader_next returns it until the consumer's
// NEXT loader_next call (which recycles it).
struct Slot {
  float* v = nullptr;       // f32 mode
  int8_t* v_q = nullptr;    // int8 mode (quantize-on-assembly)
  float* v_scale = nullptr; // int8 mode, [batch, max_boxes]
  float* b = nullptr;
  uint8_t* mask = nullptr;
  int64_t* indices = nullptr;
  int64_t rows = 0;
};

// Background prefetcher: consumes host-supplied per-epoch row orders (the
// DETERMINISM CONTRACT: Python draws the permutation with the same seeded
// numpy RandomState as the pure-Python BatchLoader, so both loaders yield
// identical batch sequences — required for multi-host lockstep), maps rows
// through a row->image table, and assembles feature slabs ahead of
// consumption.
struct Loader {
  // stores[0] is the classic single-store case; a concat dataset (train +
  // val + VisualGenome, reference FFOE/dataset.py:483-569 + README.md:49-58)
  // registers one Store per distinct member FeatureStore and maps each row
  // through row_to_store (empty => all rows store 0).
  std::vector<Store> stores;
  Store store;                        // alias of stores[0] (v_dim/s_dim)
  std::vector<int64_t> row_to_image;  // per dataset row
  std::vector<int32_t> row_to_store;  // per dataset row, may be empty
  int64_t batch_size;
  int64_t max_boxes;
  bool drop_last;
  int64_t assemble_threads = 1;  // fan-out within the prefetch worker
  bool quantize = false;  // int8 slots (assemble_range_q8)

  std::deque<std::vector<int64_t>> orders;  // pending epoch orders
  std::vector<Slot> slots;                  // registered ring buffers
  std::deque<int64_t> free_slots, ready;    // slot ids
  std::mutex mu;
  std::condition_variable cv_ready, cv_space, cv_order;
  std::atomic<bool> stop{false};
  std::thread worker;

  void run() {
    while (!stop.load()) {
      std::vector<int64_t> order;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_order.wait(lock, [&] { return !orders.empty() || stop.load(); });
        if (stop.load()) return;
        order = std::move(orders.front());
        orders.pop_front();
      }
      const int64_t n = static_cast<int64_t>(order.size());
      const int64_t stop_at = drop_last ? (n / batch_size) * batch_size : n;
      for (int64_t at = 0; at < stop_at && !stop.load(); at += batch_size) {
        int64_t slot_id;
        {
          std::unique_lock<std::mutex> lock(mu);
          cv_space.wait(lock,
                        [&] { return !free_slots.empty() || stop.load(); });
          if (stop.load()) return;
          slot_id = free_slots.front();
          free_slots.pop_front();
        }
        Slot& s = slots[slot_id];
        const int64_t rows = std::min(batch_size, stop_at - at);
        s.rows = rows;
        std::copy(order.begin() + at, order.begin() + at + rows, s.indices);
        std::vector<int64_t> images(rows);
        std::vector<int32_t> srcs(rows, 0);
        for (int64_t i = 0; i < rows; ++i) {
          images[i] = row_to_image[s.indices[i]];
          if (!row_to_store.empty()) srcs[i] = row_to_store[s.indices[i]];
        }
        // zero the padded tail rows (partial final batch)
        if (rows < batch_size) {
          const int64_t tail = batch_size - rows;
          if (quantize) {
            std::memset(s.v_q + rows * max_boxes * store.v_dim, 0,
                        tail * max_boxes * store.v_dim);
            std::fill(s.v_scale + rows * max_boxes,
                      s.v_scale + batch_size * max_boxes, 1.0f);
          } else {
            std::memset(s.v + rows * max_boxes * store.v_dim, 0,
                        tail * max_boxes * store.v_dim * sizeof(float));
          }
          std::memset(s.b + rows * max_boxes * store.s_dim, 0,
                      tail * max_boxes * store.s_dim * sizeof(float));
          std::memset(s.mask + rows * max_boxes, 0, tail * max_boxes);
        }
        auto assemble = [&](int64_t lo, int64_t hi) {
          // per-row store dispatch (all stores share v_dim/s_dim, enforced
          // by the Python binding, so output strides are uniform)
          for (int64_t i = lo; i < hi; ++i) {
            const Store& st = stores[srcs[i]];
            if (quantize) {
              assemble_one_q8(st, images[i], max_boxes,
                              s.v_q + i * max_boxes * st.v_dim,
                              s.v_scale + i * max_boxes,
                              s.b + i * max_boxes * st.s_dim,
                              s.mask + i * max_boxes);
            } else {
              assemble_one(st, images[i], max_boxes,
                           s.v + i * max_boxes * st.v_dim,
                           s.b + i * max_boxes * st.s_dim,
                           s.mask + i * max_boxes);
            }
          }
        };
        if (assemble_threads <= 1 || rows < 8) {
          assemble(0, rows);
        } else {
          std::vector<std::thread> pool;
          const int64_t chunk =
              (rows + assemble_threads - 1) / assemble_threads;
          for (int64_t t = 0; t < assemble_threads; ++t) {
            const int64_t lo = t * chunk;
            const int64_t hi = std::min(rows, lo + chunk);
            if (lo >= hi) break;
            pool.emplace_back([&assemble, lo, hi] { assemble(lo, hi); });
          }
          for (auto& th : pool) th.join();
        }
        {
          std::lock_guard<std::mutex> lock(mu);
          ready.push_back(slot_id);
        }
        cv_ready.notify_one();
      }
    }
  }
};

}  // namespace

extern "C" {

void* vqadata_store_create(const float* features, const float* spatials,
                           const int64_t* pos_boxes, int64_t n_images,
                           int64_t fixed_boxes, int64_t v_dim, int64_t s_dim) {
  auto* s = new Store{features, spatials, pos_boxes, n_images, fixed_boxes,
                      v_dim, s_dim};
  return s;
}

// int8-resident store (FeatureStore.quantized): features as q8 rows +
// per-box-row dequantization scales.
void* vqadata_store_create_q8(const int8_t* features_q, const float* f_scales,
                              const float* spatials,
                              const int64_t* pos_boxes, int64_t n_images,
                              int64_t fixed_boxes, int64_t v_dim,
                              int64_t s_dim) {
  auto* s = new Store{nullptr, spatials, pos_boxes, n_images, fixed_boxes,
                      v_dim, s_dim};
  s->features_q = features_q;
  s->f_scales = f_scales;
  return s;
}

void vqadata_store_destroy(void* handle) { delete static_cast<Store*>(handle); }

// Synchronous multithreaded gather+pad of `n` images into caller buffers.
void vqadata_assemble(void* handle, const int64_t* image_idx, int64_t n,
                      int64_t max_boxes, float* out_v, float* out_b,
                      uint8_t* out_mask, int64_t num_threads) {
  const Store& s = *static_cast<Store*>(handle);
  if (num_threads <= 1 || n < 4) {
    assemble_range(s, image_idx, 0, n, max_boxes, out_v, out_b, out_mask);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (n + num_threads - 1) / num_threads;
  for (int64_t t = 0; t < num_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([&, lo, hi] {
      assemble_range(s, image_idx, lo, hi, max_boxes, out_v, out_b, out_mask);
    });
  }
  for (auto& th : threads) th.join();
}

void* vqadata_loader_create(void* store_handle, const int64_t* row_to_image,
                            int64_t n_rows, int64_t batch_size,
                            int64_t max_boxes, int drop_last,
                            int64_t assemble_threads) {
  auto* l = new Loader();
  l->store = *static_cast<Store*>(store_handle);
  l->stores.push_back(l->store);
  l->row_to_image.assign(row_to_image, row_to_image + n_rows);
  l->batch_size = batch_size;
  l->max_boxes = max_boxes;
  l->drop_last = drop_last != 0;
  l->assemble_threads = assemble_threads;
  l->worker = std::thread([l] { l->run(); });
  return l;
}

// Multi-store loader for concatenated datasets: `store_handles` lists the
// distinct member FeatureStores (must share v_dim/s_dim), `row_to_store`
// maps each dataset row to its store, `row_to_image` to the image index
// WITHIN that store.
void* vqadata_loader_create_multi(void* const* store_handles,
                                  int64_t n_stores,
                                  const int64_t* row_to_image,
                                  const int32_t* row_to_store, int64_t n_rows,
                                  int64_t batch_size, int64_t max_boxes,
                                  int drop_last, int64_t assemble_threads) {
  auto* l = new Loader();
  for (int64_t i = 0; i < n_stores; ++i)
    l->stores.push_back(*static_cast<Store*>(store_handles[i]));
  l->store = l->stores[0];
  l->row_to_image.assign(row_to_image, row_to_image + n_rows);
  l->row_to_store.assign(row_to_store, row_to_store + n_rows);
  l->batch_size = batch_size;
  l->max_boxes = max_boxes;
  l->drop_last = drop_last != 0;
  l->assemble_threads = assemble_threads;
  l->worker = std::thread([l] { l->run(); });
  return l;
}

// Queue one epoch's dataset-row order (host-drawn; see Loader comment).
void vqadata_loader_push_order(void* handle, const int64_t* order,
                               int64_t n) {
  auto* l = static_cast<Loader*>(handle);
  std::vector<int64_t> v(order, order + n);
  {
    std::lock_guard<std::mutex> lock(l->mu);
    l->orders.push_back(std::move(v));
  }
  l->cv_order.notify_one();
}

// Register one ring slot's caller-owned output buffers.  Call for every
// slot before the first push_order; the worker assembles batches directly
// into these (see Slot lifetime comment).
void vqadata_loader_register_slot(void* handle, float* v, float* b,
                                  uint8_t* mask, int64_t* indices) {
  auto* l = static_cast<Loader*>(handle);
  Slot s;
  s.v = v;
  s.b = b;
  s.mask = mask;
  s.indices = indices;
  std::lock_guard<std::mutex> lock(l->mu);
  l->slots.push_back(s);
  l->free_slots.push_back(static_cast<int64_t>(l->slots.size()) - 1);
}

// Replace a slot's v/b output buffers.  Called by the consumer on the slot
// it currently HOLDS (returned by the last loader_next and not yet
// released), immediately before releasing it: the consumer keeps ownership
// of the previous buffers (which downstream zero-copy consumers — e.g.
// torch.from_numpy tensors or an asynchronous copy to the card — may still
// be reading) and the
// worker's next assembly into this slot lands in fresh memory.  The mutex
// orders the pointer swap before the release that publishes the slot.
void vqadata_loader_swap_vb(void* handle, int64_t slot_id, float* v,
                            float* b) {
  auto* l = static_cast<Loader*>(handle);
  std::lock_guard<std::mutex> lock(l->mu);
  l->slots[slot_id].v = v;
  l->slots[slot_id].b = b;
}

// Blocks until a batch is ready; hands back its SLOT id (zero-copy — the
// caller reads the buffers it registered).  ``release_slot`` recycles the
// previously returned slot: pass -1 on the first call, then the prior
// return value (i.e. the consumer declares batch t-1 dead when asking for
// t).  ``out_rows`` receives the number of valid rows.  Returns -1 on
// shutdown.
int64_t vqadata_loader_next(void* handle, int64_t release_slot,
                            int64_t* out_rows) {
  auto* l = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lock(l->mu);
  if (release_slot >= 0) {
    l->free_slots.push_back(release_slot);
    l->cv_space.notify_one();
  }
  l->cv_ready.wait(lock, [&] { return !l->ready.empty() || l->stop.load(); });
  if (l->ready.empty()) return -1;
  const int64_t slot_id = l->ready.front();
  l->ready.pop_front();
  *out_rows = l->slots[slot_id].rows;
  return slot_id;
}

// Switch a freshly-created loader to int8 (quantize-on-assembly) slots.
// Call BEFORE registering slots; int8 slots are registered with
// vqadata_loader_register_slot_q8 and rotated with vqadata_loader_swap_vq8.
void vqadata_loader_set_quantize(void* handle, int on) {
  static_cast<Loader*>(handle)->quantize = on != 0;
}

void vqadata_loader_register_slot_q8(void* handle, int8_t* v_q,
                                     float* v_scale, float* b, uint8_t* mask,
                                     int64_t* indices) {
  auto* l = static_cast<Loader*>(handle);
  Slot s;
  s.v_q = v_q;
  s.v_scale = v_scale;
  s.b = b;
  s.mask = mask;
  s.indices = indices;
  {
    std::lock_guard<std::mutex> lock(l->mu);
    l->slots.push_back(s);
    l->free_slots.push_back(static_cast<int64_t>(l->slots.size()) - 1);
  }
  l->cv_space.notify_one();
}

// int8-mode ownership rotation (the f32 swap_vb analog): the consumer hands
// fresh v_q/v_scale/b buffers before recycling a slot, keeping the yielded
// batch's buffers with their holders (torch.from_numpy aliases them).
void vqadata_loader_swap_vq8(void* handle, int64_t slot_id, int8_t* v_q,
                             float* v_scale, float* b) {
  auto* l = static_cast<Loader*>(handle);
  std::lock_guard<std::mutex> lock(l->mu);
  Slot& s = l->slots[slot_id];
  s.v_q = v_q;
  s.v_scale = v_scale;
  s.b = b;
}

// Synchronous int8 gather+quantize+pad (the vqadata_assemble analog).
void vqadata_assemble_q8(void* handle, const int64_t* image_idx, int64_t n,
                         int64_t max_boxes, int8_t* out_v, float* out_scale,
                         float* out_b, uint8_t* out_mask,
                         int64_t num_threads) {
  const Store& s = *static_cast<Store*>(handle);
  if (num_threads <= 1 || n < 4) {
    assemble_range_q8(s, image_idx, 0, n, max_boxes, out_v, out_scale, out_b,
                      out_mask);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (n + num_threads - 1) / num_threads;
  for (int64_t t = 0; t < num_threads; ++t) {
    const int64_t lo = t * chunk;
    if (lo >= n) break;
    const int64_t hi = std::min(n, lo + chunk);
    threads.emplace_back([&s, image_idx, lo, hi, max_boxes, out_v, out_scale,
                          out_b, out_mask] {
      assemble_range_q8(s, image_idx, lo, hi, max_boxes, out_v, out_scale,
                        out_b, out_mask);
    });
  }
  for (auto& th : threads) th.join();
}

// Per-row symmetric int8 quantization for the transfer_dtype="int8" wire
// (the Python steps.quantize_v contract): scale = absmax(row)/127 (1.0 for
// all-zero rows), q = rint(v/scale).  One pass per row — each 2048-float
// row stays in L1, so this runs at read bandwidth where the numpy
// expression pays 3-4 full-array passes (abs temp, divide temp, rint,
// astype).  `rows` = product of the leading dims, `d` = the minor dim.
void vqadata_quantize_rows(const float* v, int64_t rows, int64_t d,
                           int8_t* q, float* scale, int64_t num_threads) {
  auto quant_range = [=](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      quantize_row(v + r * d, d, q + r * d, scale + r);
    }
  };
  if (num_threads <= 1 || rows < 64) {
    quant_range(0, rows);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (rows + num_threads - 1) / num_threads;
  for (int64_t t = 0; t < num_threads; ++t) {
    const int64_t lo = t * chunk;
    if (lo >= rows) break;
    threads.emplace_back(quant_range, lo, std::min(rows, lo + chunk));
  }
  for (auto& th : threads) th.join();
}

void vqadata_loader_destroy(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  l->stop.store(true);
  l->cv_ready.notify_all();
  l->cv_space.notify_all();
  l->cv_order.notify_all();
  if (l->worker.joinable()) l->worker.join();
  delete l;
}

}  // extern "C"

// Native runtime: host staging arena + threaded CSV parse + async prefetch.
//
// The port's copy of deeplearning4j_tpu/native/csrc/dl4jtpu_native.cpp. The
// parse, the markers and the file order are the reference's; the pipeline's
// wake-ups are repaired. In the reference a pop woke one parked worker
// (notify_one) and a worker counted itself done outside the mutex, so with
// more workers parked than batches left, or a consumer between its check and
// its wait, a wake-up was lost, done_workers never reached n_threads and
// pipe_next waited forever. Here every state change a waiter's predicate
// reads (ready, parked, next_emit, done_workers, stop) is made under `mu`,
// and every emit, pop, exit and stop wakes all waiters of both variables.
// One read is repaired too: a worker's file buffer ends in a NUL, so the
// last cell of a file without a final newline parses as parse_csv parses
// it (see Pipeline::worker).
//
// Reference parity: the reference keeps its data path and memory management
// native — DataVec record readers feed off-heap buffers (NativeImageLoader /
// RecordConverter), AsyncDataSetIterator prefetches on dedicated threads, and
// workspaces (libnd4j include/memory/Workspace.h, MemoryRegistrator.h —
// path-cite, mount empty this round) provide arena allocation outside the
// GC. The compute path stays on the device; this module is the native runtime
// AROUND it: the ETL hot loop (file IO + float parsing, the classic host
// bottleneck that starves the accelerator) runs here on C++ threads that
// never touch the Python GIL, double-buffered into page-aligned host arenas
// ready to be copied to the device.
//
// Exposed as a flat C ABI (the reference's NativeOps.h style) consumed via
// ctypes — no pybind11 dependency.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <deque>
#include <fstream>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Host staging arena (workspace parity): bump allocator over one aligned slab
// ---------------------------------------------------------------------------

struct Arena {
  uint8_t* base;
  size_t capacity;
  std::atomic<size_t> used;
};

void* arena_create(size_t bytes) {
  void* mem = nullptr;
  if (posix_memalign(&mem, 4096, bytes) != 0) return nullptr;  // page-aligned
  Arena* a = new Arena();
  a->base = static_cast<uint8_t*>(mem);
  a->capacity = bytes;
  a->used.store(0);
  return a;
}

void* arena_alloc(void* arena, size_t bytes, size_t align) {
  Arena* a = static_cast<Arena*>(arena);
  if (align == 0) align = 64;
  size_t cur, next;
  do {
    cur = a->used.load();
    size_t aligned = (cur + align - 1) & ~(align - 1);
    next = aligned + bytes;
    if (next > a->capacity) return nullptr;
  } while (!a->used.compare_exchange_weak(cur, next));
  size_t aligned = (next - bytes);
  return a->base + aligned;
}

void arena_reset(void* arena) { static_cast<Arena*>(arena)->used.store(0); }

size_t arena_used(void* arena) { return static_cast<Arena*>(arena)->used.load(); }

size_t arena_capacity(void* arena) { return static_cast<Arena*>(arena)->capacity; }

void arena_destroy(void* arena) {
  Arena* a = static_cast<Arena*>(arena);
  free(a->base);
  delete a;
}

// ---------------------------------------------------------------------------
// CSV parsing (CSVRecordReader hot loop, natively)
// ---------------------------------------------------------------------------

// count data rows (non-empty lines)
long csv_count_rows(const char* data, size_t len) {
  long rows = 0;
  bool in_line = false;
  for (size_t i = 0; i < len; i++) {
    if (data[i] == '\n') {
      if (in_line) rows++;
      in_line = false;
    } else if (data[i] != '\r') {
      in_line = true;
    }
  }
  if (in_line) rows++;
  return rows;
}

// parse up to max_rows lines of `cols` floats; returns rows parsed, -1 on
// malformed input (wrong column count)
long csv_parse(const char* data, size_t len, char delim, float* out,
               long max_rows, long cols) {
  long row = 0;
  size_t i = 0;
  while (i < len && row < max_rows) {
    // skip blank lines
    while (i < len && (data[i] == '\n' || data[i] == '\r')) i++;
    if (i >= len) break;
    long col = 0;
    while (i < len && data[i] != '\n') {
      char* end = nullptr;
      float v = strtof(data + i, &end);
      if (end == data + i) {  // not a number (e.g. quoted text) → NaN
        v = NAN;
        while (i < len && data[i] != delim && data[i] != '\n' &&
               data[i] != '\r')
          i++;
        end = const_cast<char*>(data + i);
      }
      if (col >= cols) return -1;
      out[row * cols + col] = v;
      col++;
      i = end - data;
      while (i < len && data[i] == ' ') i++;
      if (i < len && data[i] == delim) i++;
      while (i < len && data[i] == '\r') i++;
    }
    if (col != cols) return -1;
    row++;
    if (i < len) i++;  // consume '\n'
  }
  return row;
}

// ---------------------------------------------------------------------------
// Async file pipeline (AsyncDataSetIterator parity): worker threads read +
// parse whole files, bounded ring hands them to the consumer
// ---------------------------------------------------------------------------

struct Batch {
  float* data;
  long rows;
  int file_idx;
};

struct Pipeline {
  std::vector<std::string> paths;
  int cols;
  char delim;
  size_t capacity;
  std::deque<Batch> ready;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::atomic<int> next_file{0};
  std::atomic<int> done_workers{0};
  std::atomic<bool> stop{false};
  int n_threads;
  std::vector<std::thread> workers;
  // files must be delivered in order (determinism parity with the
  // single-threaded reader): workers park finished files until their turn
  std::atomic<int> next_emit{0};
  std::deque<Batch> parked;

  void worker() {
    for (;;) {
      int idx = next_file.fetch_add(1);
      if (idx >= static_cast<int>(paths.size()) || stop.load()) break;
      std::ifstream f(paths[idx], std::ios::binary | std::ios::ate);
      Batch b{nullptr, 0, idx};
      if (f) {
        size_t len = f.tellg();
        f.seekg(0);
        // one NUL past the end: strtof stops there on a last cell with no
        // newline after it (the reference's buffer has none, so strtof read
        // on past the file's bytes and could take heap bytes as digits)
        std::vector<char> buf(len + 1, '\0');
        f.read(buf.data(), len);
        long rows = csv_count_rows(buf.data(), len);
        float* out = static_cast<float*>(malloc(sizeof(float) * rows * cols));
        long parsed = csv_parse(buf.data(), len, delim, out, rows, cols);
        if (parsed < 0) {
          free(out);
          b.rows = -1;  // malformed marker
        } else {
          b.data = out;
          b.rows = parsed;
        }
      } else {
        b.rows = -2;  // unreadable marker
      }
      std::unique_lock<std::mutex> lk(mu);
      parked.push_back(b);
      // drain in-order parked batches into the ready queue. NOTE: cv waits
      // release the lock, so other workers may erase from `parked` and
      // advance next_emit meanwhile — iterators must be RE-FOUND after every
      // wait, never held across one (TSan-caught use-after-free otherwise).
      for (;;) {
        auto find_next = [&] {
          for (auto it = parked.begin(); it != parked.end(); ++it)
            if (it->file_idx == next_emit.load()) return it;
          return parked.end();
        };
        if (find_next() == parked.end()) break;
        cv_push.wait(lk, [&] {
          return ready.size() < capacity || stop.load();
        });
        if (stop.load()) return;
        auto it = find_next();  // re-find: state may have changed in the wait
        if (it == parked.end()) break;
        ready.push_back(*it);
        parked.erase(it);
        next_emit.fetch_add(1);
        // the consumer may pop; another parked worker may hold the file
        // that is next now
        cv_pop.notify_all();
        cv_push.notify_all();
      }
    }
    std::lock_guard<std::mutex> lk(mu);  // counted under the mutex: a
    done_workers.fetch_add(1);           // consumer between its check and
    cv_pop.notify_all();                 // its wait cannot miss it
    cv_push.notify_all();
  }
};

void* pipe_create(const char** paths, int n_paths, int cols, char delim,
                  int n_threads, int capacity) {
  Pipeline* p = new Pipeline();
  for (int i = 0; i < n_paths; i++) p->paths.emplace_back(paths[i]);
  p->cols = cols;
  p->delim = delim;
  p->capacity = capacity > 0 ? capacity : 4;
  p->n_threads = n_threads > 0 ? n_threads : 2;
  for (int t = 0; t < p->n_threads; t++)
    p->workers.emplace_back([p] { p->worker(); });
  return p;
}

// → rows (>=0), or -1 malformed file, -2 unreadable file, -3 exhausted
long pipe_next(void* pipe, float** out_data, int* out_file_idx) {
  Pipeline* p = static_cast<Pipeline*>(pipe);
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_pop.wait(lk, [&] {
    return !p->ready.empty() || p->done_workers.load() == p->n_threads;
  });
  if (p->ready.empty()) return -3;
  Batch b = p->ready.front();
  p->ready.pop_front();
  p->cv_push.notify_all();  // every parked worker re-checks: one of them
                            // may be the only one able to move
  *out_data = b.data;
  *out_file_idx = b.file_idx;
  return b.rows;
}

void pipe_free_batch(float* data) { free(data); }

void pipe_destroy(void* pipe) {
  Pipeline* p = static_cast<Pipeline*>(pipe);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop.store(true);
    p->cv_push.notify_all();
    p->cv_pop.notify_all();
  }
  for (auto& t : p->workers) t.join();
  for (auto& b : p->ready)
    if (b.data) free(b.data);
  for (auto& b : p->parked)
    if (b.data) free(b.data);
  delete p;
}

}  // extern "C"

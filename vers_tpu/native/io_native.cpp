// Native host-side IO for vers_tpu.
//
// The reference's runtime is entirely native (Rust): its dataset loader
// (`vers/src/utils.rs:7-66`) and bincode persistence
// (`vers/src/indexes/base.rs:31-58`) run at native speed. The JAX
// rebuild keeps the *compute* path on-device (JAX/XLA/Pallas), and this
// library provides the native equivalents of the host-side runtime:
//
//  - vers_parse_vec:  fastText/GloVe `.vec` text parser (the Python
//    per-line loop takes minutes at 1M x 300 on this host; this is
//    a single pass with strtof).
//  - vers_hnsw_scan:  one-pass structural scan of an HNSW bincode file
//    (`hnsw.rs:20-32` + `models.rs:149-153` layout) into flat arrays,
//    replacing ~10M tiny Python struct.unpack calls with bulk numpy
//    views on the Python side.
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).
// Build: make native   (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

// Fast decimal float parse (Clinger fast path): digits accumulate into
// a u64 mantissa, scaled by an exact power of ten in double. Matches
// the Python reference path's rounding exactly (numpy/python parse via
// double, then cast to f32). Falls back to strtod for anything unusual
// (too many digits, huge exponents, inf/nan/hex).
static const double kPow10[23] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10, 1e11,
    1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

static inline float fast_strtof(const char *p, char **endp) {
  const char *s = p;
  while (*s == ' ' || *s == '\t' || *s == '\r') s++;
  bool neg = false;
  if (*s == '-') {
    neg = true;
    s++;
  } else if (*s == '+') {
    s++;
  }
  uint64_t mant = 0;
  int digits = 0, frac = 0;
  const char *d0 = s;
  while (*s >= '0' && *s <= '9') {
    mant = mant * 10 + static_cast<uint64_t>(*s - '0');
    digits++;
    s++;
  }
  if (*s == '.') {
    s++;
    while (*s >= '0' && *s <= '9') {
      mant = mant * 10 + static_cast<uint64_t>(*s - '0');
      digits++;
      frac++;
      s++;
    }
  }
  if (s == d0 || (*d0 == '.' && digits == 0)) {
    // no digits (could be inf/nan/hex) -> libc
    return static_cast<float>(strtod(p, endp));
  }
  int exp10 = -frac;
  if (*s == 'e' || *s == 'E') {
    const char *es = s + 1;
    bool eneg = false;
    if (*es == '-') {
      eneg = true;
      es++;
    } else if (*es == '+') {
      es++;
    }
    int ev = 0;
    const char *ed = es;
    while (*es >= '0' && *es <= '9' && ev < 100000) {
      ev = ev * 10 + (*es - '0');
      es++;
    }
    if (es != ed) {
      exp10 += eneg ? -ev : ev;
      s = es;
    }
  }
  if (digits > 18 || exp10 > 22 || exp10 < -22) {
    return static_cast<float>(strtod(p, endp));
  }
  double v = static_cast<double>(mant);
  v = exp10 >= 0 ? v * kPow10[exp10] : v / kPow10[-exp10];
  *endp = const_cast<char *>(s);
  return static_cast<float>(neg ? -v : v);
}

extern "C" {

// ---------------------------------------------------------------- .vec

struct VecFile {
  // row-major (n, dim) float32 embedding matrix
  float *data;
  // concatenated UTF-8 words and their end offsets (n entries)
  char *words;
  uint64_t *word_ends;
  uint64_t n_rows;
  uint64_t words_len;
};

// Parse a fastText/GloVe .vec text file. `header` skips the first line.
// `max_rows` <= 0 means unlimited. Lines with fewer than dim+1 fields
// are skipped (parity with the Python loader). Returns NULL on IO error.
VecFile *vers_parse_vec(const char *path, int64_t dim, int header,
                        int64_t max_rows) {
  FILE *fp = std::fopen(path, "rb");
  if (!fp) return nullptr;

  // read whole file (host RAM is the same order as the parsed output)
  std::fseek(fp, 0, SEEK_END);
  long fsize = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  char *buf = static_cast<char *>(std::malloc(fsize + 1));
  if (!buf) {
    std::fclose(fp);
    return nullptr;
  }
  size_t got = std::fread(buf, 1, fsize, fp);
  std::fclose(fp);
  buf[got] = '\0';

  std::vector<float> data;
  std::vector<char> words;
  std::vector<uint64_t> word_ends;
  data.reserve(1 << 20);

  char *p = buf;
  char *end = buf + got;
  if (header) {
    while (p < end && *p != '\n') p++;
    if (p < end) p++;
  }
  std::vector<float> row(static_cast<size_t>(dim));
  while (p < end) {
    char *line_end = static_cast<char *>(std::memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    *line_end = '\0';

    // token 1: the word (space-separated; fastText words can contain
    // any non-space bytes)
    char *sp = static_cast<char *>(std::memchr(p, ' ', line_end - p));
    bool ok = sp != nullptr;
    char *q = ok ? sp + 1 : p;
    int64_t col = 0;
    if (ok) {
      while (col < dim && q < line_end) {
        char *next = nullptr;
        float v = fast_strtof(q, &next);
        if (next == q) break;  // not a number
        row[static_cast<size_t>(col++)] = v;
        q = next;
        while (q < line_end && *q == ' ') q++;
      }
    }
    if (ok && col == dim) {
      data.insert(data.end(), row.begin(), row.end());
      words.insert(words.end(), p, sp);
      word_ends.push_back(words.size());
      if (max_rows > 0 &&
          word_ends.size() >= static_cast<uint64_t>(max_rows)) {
        break;
      }
    }
    p = line_end + 1;
  }
  std::free(buf);

  VecFile *out = new VecFile();
  out->n_rows = word_ends.size();
  out->words_len = words.size();
  out->data =
      static_cast<float *>(std::malloc(sizeof(float) * data.size() + 1));
  std::memcpy(out->data, data.data(), sizeof(float) * data.size());
  out->words = static_cast<char *>(std::malloc(words.size() + 1));
  std::memcpy(out->words, words.data(), words.size());
  out->word_ends = static_cast<uint64_t *>(
      std::malloc(sizeof(uint64_t) * word_ends.size() + 1));
  std::memcpy(out->word_ends, word_ends.data(),
              sizeof(uint64_t) * word_ends.size());
  return out;
}

void vers_free_vec(VecFile *v) {
  if (!v) return;
  std::free(v->data);
  std::free(v->words);
  std::free(v->word_ends);
  delete v;
}

// --------------------------------------------------------- HNSW bincode

// Flattened decode of the HNSW bincode layout (field order
// `hnsw.rs:20-32`; AdjacencyItemSer `models.rs:149-153`; bincode 1.3
// legacy defaults: LE fixed-width ints, usize->u64, Vec = u64 count +
// elements). One pass over the file; all variable-length payloads land
// in flat arrays the Python side wraps as numpy views:
//
//   per layer:   node count
//   per node:    id, heap length, neighbour length
//   heap pairs:  (u64 id, f32 dist) streams, concatenated
//   neighbours:  u64 stream, concatenated
//   tail:        layer_multiplier, id->vec pairs as ids[] + (n, dim) f32
struct HnswScan {
  uint64_t ef_construction, ef_search, num_neighbours, num_layers;
  uint64_t *layer_counts;    // (num_layers,)
  uint64_t n_nodes_total;    // sum(layer_counts)
  uint64_t *node_ids;        // (n_nodes_total,)
  uint64_t *heap_lens;       // (n_nodes_total,)
  uint64_t *nbr_lens;        // (n_nodes_total,)
  uint64_t *heap_ids;        // (sum heap_lens,)
  float *heap_dists;         // (sum heap_lens,)
  uint64_t *nbrs;            // (sum nbr_lens,)
  uint64_t heap_total, nbr_total;
  float layer_multiplier;
  uint64_t n_vecs;
  uint64_t *vec_ids;         // (n_vecs,)
  float *vecs;               // (n_vecs, dim)
  int error;                 // 0 ok, 1 truncated/corrupt
};

static inline int rd(const char *&p, const char *end, void *dst, size_t n) {
  if (static_cast<size_t>(end - p) < n) return 1;
  std::memcpy(dst, p, n);
  p += n;
  return 0;
}

HnswScan *vers_hnsw_scan(const char *path, int64_t dim) {
  FILE *fp = std::fopen(path, "rb");
  if (!fp) return nullptr;
  std::fseek(fp, 0, SEEK_END);
  long fsize = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  char *buf = static_cast<char *>(std::malloc(fsize > 0 ? fsize : 1));
  size_t got = std::fread(buf, 1, fsize, fp);
  std::fclose(fp);

  const char *p = buf;
  const char *end = buf + got;
  HnswScan *s = new HnswScan();
  std::memset(s, 0, sizeof(*s));

  std::vector<uint64_t> layer_counts, node_ids, heap_lens, nbr_lens,
      heap_ids, nbrs, vec_ids;
  std::vector<float> heap_dists, vecs;

#define RD(v) \
  if (rd(p, end, &(v), sizeof(v))) goto fail;

  RD(s->ef_construction)
  RD(s->ef_search)
  RD(s->num_neighbours)
  RD(s->num_layers)
  for (uint64_t l = 0; l < s->num_layers; l++) {
    uint64_t count;
    RD(count)
    layer_counts.push_back(count);
    for (uint64_t i = 0; i < count; i++) {
      uint64_t nid, hlen;
      RD(nid)
      RD(hlen)
      node_ids.push_back(nid);
      heap_lens.push_back(hlen);
      for (uint64_t h = 0; h < hlen; h++) {
        uint64_t cid;
        float dist;
        RD(cid)
        RD(dist)
        heap_ids.push_back(cid);
        heap_dists.push_back(dist);
      }
      uint64_t nlen;
      RD(nlen)
      nbr_lens.push_back(nlen);
      size_t base = nbrs.size();
      nbrs.resize(base + nlen);
      if (rd(p, end, nbrs.data() + base, nlen * 8)) goto fail;
    }
  }
  RD(s->layer_multiplier)
  RD(s->n_vecs)
  vec_ids.resize(s->n_vecs);
  vecs.resize(s->n_vecs * static_cast<uint64_t>(dim));
  for (uint64_t i = 0; i < s->n_vecs; i++) {
    if (rd(p, end, &vec_ids[i], 8)) goto fail;
    if (rd(p, end, vecs.data() + i * dim, 4 * dim)) goto fail;
  }
  goto done;
fail:
  s->error = 1;
done:
#undef RD
  std::free(buf);
  auto dup_u64 = [](const std::vector<uint64_t> &v) {
    auto *o = static_cast<uint64_t *>(std::malloc(8 * v.size() + 1));
    std::memcpy(o, v.data(), 8 * v.size());
    return o;
  };
  auto dup_f32 = [](const std::vector<float> &v) {
    auto *o = static_cast<float *>(std::malloc(4 * v.size() + 1));
    std::memcpy(o, v.data(), 4 * v.size());
    return o;
  };
  s->layer_counts = dup_u64(layer_counts);
  s->node_ids = dup_u64(node_ids);
  s->heap_lens = dup_u64(heap_lens);
  s->nbr_lens = dup_u64(nbr_lens);
  s->heap_ids = dup_u64(heap_ids);
  s->heap_dists = dup_f32(heap_dists);
  s->nbrs = dup_u64(nbrs);
  s->vec_ids = dup_u64(vec_ids);
  s->vecs = dup_f32(vecs);
  s->n_nodes_total = node_ids.size();
  s->heap_total = heap_ids.size();
  s->nbr_total = nbrs.size();
  return s;
}

void vers_free_hnsw(HnswScan *s) {
  if (!s) return;
  std::free(s->layer_counts);
  std::free(s->node_ids);
  std::free(s->heap_lens);
  std::free(s->nbr_lens);
  std::free(s->heap_ids);
  std::free(s->heap_dists);
  std::free(s->nbrs);
  std::free(s->vec_ids);
  std::free(s->vecs);
  delete s;
}

}  // extern "C"

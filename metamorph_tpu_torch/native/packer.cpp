// Native host-side runtime: multimodal sequence packing + JSONL indexing.
//
// A copy of native/packer.cpp, the JAX package's packer, kept here so the
// PyTorch package builds its own library from its own tree. The packer is
// the per-step host hot path (the device step consumes its fixed-shape index
// maps; see metamorph_tpu_torch/multimodal/packing.py for the algorithm spec).
// This C++ implementation is semantically identical to the Python packer;
// tests/test_torch_data.py holds the two to equal outputs.
//
// Exposed via a C ABI for ctypes. metamorph_tpu_torch/multimodal/native.py
// builds it on first use: g++ -O3 -fPIC -std=c++17 -shared, no -march=native.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t kIgnoreIndex = -100;
constexpr int32_t kImageToken = -200;
constexpr int32_t kImStartId = 128256;

struct TokenEvent {
  int32_t token;
  int32_t label;
  int32_t img;    // image slot or -1
  int32_t j;      // token index within image
  bool answer;
};

}  // namespace

extern "C" {

// Packs B variable-length rows (concatenated ids/labels with row_lens) into
// fixed [B,T] planes. Returns 0 on success, <0 on error:
//   -1 slot overflow mid-row, -2 total slots exceed budget,
//   -3 image count exceeds tokens_per_image entries.
//
// tokens_per_image (nullable, n_tpi entries): per-slot variable token counts
// (anyres); slot base offsets in the flat image-token table become cumulative
// sums and the table capacity is gather_capacity. Uniform mode when null.
int mm_pack(const int32_t* ids, const int32_t* labels, const int32_t* row_lens,
            int B, int K, int T, int N, int left_pad,
            const int32_t* tokens_per_image, int n_tpi, int gather_capacity,
            int32_t* tokens, int32_t* labels_out, int32_t* attn, int32_t* pos,
            int32_t* gather, uint8_t* is_img, int32_t* ar_mask,
            int32_t* ar_b, int32_t* ar_p, int32_t* ar_t, float* ar_v,
            float* slot_used) {
  std::vector<int32_t> offsets;
  if (tokens_per_image) {
    offsets.resize(n_tpi + 1);
    offsets[0] = 0;
    for (int i = 0; i < n_tpi; ++i) offsets[i + 1] = offsets[i] + tokens_per_image[i];
  }
  const int A = tokens_per_image
                    ? (gather_capacity > 0 ? gather_capacity : offsets[n_tpi])
                    : N * K;
  // zero/default-fill outputs
  for (int i = 0; i < B * T; ++i) {
    tokens[i] = 0;
    labels_out[i] = kIgnoreIndex;
    attn[i] = 0;
    pos[i] = 0;
    gather[i] = A;  // dummy row
    is_img[i] = 0;
    ar_mask[i] = 0;
  }
  for (int i = 0; i < A; ++i) {
    ar_b[i] = 0; ar_p[i] = 0; ar_t[i] = 0; ar_v[i] = 0.f;
  }
  for (int i = 0; i < N; ++i) slot_used[i] = 0.f;

  int n_ar = 0;
  int cur_image_idx = 0;
  int64_t offset_in = 0;

  std::vector<TokenEvent> seq;
  std::vector<int> sentinels;

  for (int b = 0; b < B; ++b) {
    const int L_in = row_lens[b];
    const int32_t* row_ids = ids + offset_in;
    const int32_t* row_labs = labels + offset_in;
    offset_in += L_in;

    seq.clear();
    sentinels.clear();
    for (int i = 0; i < L_in; ++i)
      if (row_ids[i] == kImageToken) sentinels.push_back(i);

    if (sentinels.empty()) {
      // text-only sample consumes one placeholder slot (reference quirk)
      ++cur_image_idx;
      for (int i = 0; i < L_in; ++i)
        seq.push_back({row_ids[i], row_labs[i], -1, 0, false});
    } else {
      bool need_to_stop = false;
      int prev = -1;
      const int n_img = static_cast<int>(sentinels.size());
      for (int c = 0; c <= n_img; ++c) {
        const int end = (c < n_img) ? sentinels[c] : L_in;
        if (!need_to_stop) {
          for (int i = prev + 1; i < end; ++i)
            seq.push_back({row_ids[i], row_labs[i], -1, 0, false});
        }
        if (c < n_img) {
          // answer image iff the label right before the sentinel is <image_start>
          const bool has_chunk = end - (prev + 1) > 0;
          const bool answer = has_chunk && row_labs[end - 1] == kImStartId;
          int Ki = K;
          if (tokens_per_image) {
            if (cur_image_idx >= n_tpi) return -3;
            Ki = tokens_per_image[cur_image_idx];
          }
          if (static_cast<int>(seq.size()) + Ki > T) {
            need_to_stop = true;
          } else {
            const int slot = cur_image_idx;
            if (slot >= N) return -1;
            for (int j = 0; j < Ki; ++j)
              seq.push_back({0, kIgnoreIndex, slot, j, answer});
          }
          ++cur_image_idx;
        }
        prev = end;
      }
    }

    const int L = static_cast<int>(seq.size()) < T
                      ? static_cast<int>(seq.size()) : T;
    const int off = left_pad ? (T - L) : 0;
    for (int s = 0; s < L; ++s) {
      const TokenEvent& ev = seq[s];
      const int t = off + s;
      const int64_t idx = static_cast<int64_t>(b) * T + t;
      attn[idx] = 1;
      pos[idx] = s;
      if (ev.img >= 0) {
        is_img[idx] = 1;
        const int32_t base =
            tokens_per_image ? offsets[ev.img] : ev.img * K;
        gather[idx] = base + ev.j;
        slot_used[ev.img] = 1.f;
        if (ev.answer) {
          ar_mask[idx] = 1;
          if (s > 0 && n_ar < A) {
            ar_b[n_ar] = b;
            ar_p[n_ar] = t - 1;
            ar_t[n_ar] = base + ev.j;
            ar_v[n_ar] = 1.f;
            ++n_ar;
          }
        }
      } else {
        tokens[idx] = ev.token;
        labels_out[idx] = ev.label;
      }
    }
  }

  if (cur_image_idx > N) return -2;
  return 0;
}

// Byte-offset index of newline-delimited records. First call with
// offsets=nullptr to get the line count; then with a buffer of that size.
long jsonl_index(const char* path, int64_t* offsets, long capacity) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::vector<char> buf(1 << 20);
  long count = 0;
  int64_t pos = 0;
  int64_t line_start = 0;
  bool line_has_bytes = false;
  size_t got;
  while ((got = std::fread(buf.data(), 1, buf.size(), f)) > 0) {
    for (size_t i = 0; i < got; ++i) {
      if (!line_has_bytes) {
        line_start = pos + static_cast<int64_t>(i);
        line_has_bytes = true;
      }
      if (buf[i] == '\n') {
        if (offsets) {
          if (count >= capacity) { std::fclose(f); return -2; }
          offsets[count] = line_start;
        }
        ++count;
        line_has_bytes = false;
      }
    }
    pos += static_cast<int64_t>(got);
  }
  if (line_has_bytes) {  // trailing record without newline
    if (offsets) {
      if (count >= capacity) { std::fclose(f); return -2; }
      offsets[count] = line_start;
    }
    ++count;
  }
  std::fclose(f);
  return count;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// modality_lengths: one streaming pass over a sample JSONL.
//
// out[i] = sign-coded conversation word count for line i: positive when the
// sample has a top-level "image" that is not null, negative when text-only
// (the convention of the reference's modality-grouped sampler,
// metamorph/train/metamorph_trainer.py:66-91 / LLaVA's modality_lengths).
// Word count = Python str.split() semantics over every conversations[*].value
// string (unicode whitespace splits, escapes decoded), min 1.
// ---------------------------------------------------------------------------

namespace {

bool is_py_space(uint32_t cp) {
  // Python str.split() whitespace set (BMP members that matter in practice)
  switch (cp) {
    case 0x09: case 0x0a: case 0x0b: case 0x0c: case 0x0d:
    case 0x1c: case 0x1d: case 0x1e: case 0x1f:
    case 0x20: case 0x85: case 0xa0: case 0x1680:
    case 0x2028: case 0x2029: case 0x202f: case 0x205f: case 0x3000:
      return true;
    default:
      return cp >= 0x2000 && cp <= 0x200a;
  }
}

struct Cursor {
  const char* p;
  const char* end;
  bool ok() const { return p < end; }
  char peek() const { return *p; }
  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
      ++p;
  }
};

// Scans a JSON string starting at the opening quote. If words != nullptr,
// counts Python-split words (decoding escapes and UTF-8). Leaves the cursor
// past the closing quote. Returns false on malformed input.
bool scan_string(Cursor& c, int32_t* words) {
  if (!c.ok() || c.peek() != '"') return false;
  ++c.p;
  bool in_word = false;
  int32_t n = 0;
  while (c.ok()) {
    unsigned char ch = static_cast<unsigned char>(*c.p);
    if (ch == '"') {
      ++c.p;
      if (words) *words += n;
      return true;
    }
    uint32_t cp;
    if (ch == '\\') {
      ++c.p;
      if (!c.ok()) return false;
      char e = *c.p++;
      switch (e) {
        case 'n': cp = 0x0a; break;
        case 't': cp = 0x09; break;
        case 'r': cp = 0x0d; break;
        case 'f': cp = 0x0c; break;
        case 'b': cp = 0x08; break;
        case 'u': {
          if (c.end - c.p < 4) return false;
          cp = 0;
          for (int i = 0; i < 4; ++i) {
            char h = *c.p++;
            cp <<= 4;
            if (h >= '0' && h <= '9') cp |= h - '0';
            else if (h >= 'a' && h <= 'f') cp |= h - 'a' + 10;
            else if (h >= 'A' && h <= 'F') cp |= h - 'A' + 10;
            else return false;
          }
          break;
        }
        default: cp = static_cast<uint32_t>(e); break;  // \" \\ \/ ...
      }
    } else if (ch < 0x80) {
      cp = ch;
      ++c.p;
    } else {
      // UTF-8 decode (2-4 bytes); malformed bytes treated as non-space
      int extra = (ch >= 0xf0) ? 3 : (ch >= 0xe0) ? 2 : 1;
      cp = ch & (0x3f >> extra);
      ++c.p;
      for (int i = 0; i < extra && c.ok(); ++i) {
        cp = (cp << 6) | (static_cast<unsigned char>(*c.p) & 0x3f);
        ++c.p;
      }
    }
    if (words) {
      if (is_py_space(cp)) {
        in_word = false;
      } else if (!in_word) {
        in_word = true;
        ++n;
      }
    }
  }
  return false;
}

bool skip_value(Cursor& c);

bool skip_container(Cursor& c, char open, char close) {
  ++c.p;  // past open
  c.skip_ws();
  if (c.ok() && c.peek() == close) { ++c.p; return true; }
  while (c.ok()) {
    if (open == '{') {
      if (!scan_string(c, nullptr)) return false;  // key
      c.skip_ws();
      if (!c.ok() || c.peek() != ':') return false;
      ++c.p;
    }
    if (!skip_value(c)) return false;
    c.skip_ws();
    if (!c.ok()) return false;
    if (c.peek() == ',') { ++c.p; c.skip_ws(); continue; }
    if (c.peek() == close) { ++c.p; return true; }
    return false;
  }
  return false;
}

bool skip_value(Cursor& c) {
  c.skip_ws();
  if (!c.ok()) return false;
  char ch = c.peek();
  if (ch == '"') return scan_string(c, nullptr);
  if (ch == '{') return skip_container(c, '{', '}');
  if (ch == '[') return skip_container(c, '[', ']');
  // literal: number / true / false / null
  while (c.ok() && *c.p != ',' && *c.p != '}' && *c.p != ']' &&
         *c.p != ' ' && *c.p != '\t' && *c.p != '\r' && *c.p != '\n')
    ++c.p;
  return true;
}

// Parses one conversations[i] element, adding its "value" words.
bool scan_turn(Cursor& c, int32_t* words) {
  c.skip_ws();
  if (!c.ok()) return false;
  if (c.peek() != '{') return skip_value(c);  // non-object turn: 0 words
  ++c.p;
  c.skip_ws();
  if (c.ok() && c.peek() == '}') { ++c.p; return true; }
  while (c.ok()) {
    Cursor key_at = c;
    if (!scan_string(c, nullptr)) return false;
    const bool is_value = (c.p - key_at.p) == 7 &&
                          std::memcmp(key_at.p, "\"value\"", 7) == 0;
    c.skip_ws();
    if (!c.ok() || c.peek() != ':') return false;
    ++c.p;
    c.skip_ws();
    if (is_value && c.ok() && c.peek() == '"') {
      if (!scan_string(c, words)) return false;
    } else {
      if (is_value && c.ok() && c.peek() != 'n')
        *words += 1;  // str(non-string scalar) ~ one word
      if (!skip_value(c)) return false;
    }
    c.skip_ws();
    if (!c.ok()) return false;
    if (c.peek() == ',') { ++c.p; c.skip_ws(); continue; }
    if (c.peek() == '}') { ++c.p; return true; }
    return false;
  }
  return false;
}

// One line -> sign-coded word count. Returns false on malformed JSON.
bool modality_length_line(const char* begin, const char* end, int32_t* out) {
  Cursor c{begin, end};
  c.skip_ws();
  if (!c.ok() || c.peek() != '{') return false;
  ++c.p;
  int32_t words = 0;
  bool has_image = false;
  c.skip_ws();
  if (c.ok() && c.peek() == '}') { *out = -1; return true; }
  while (c.ok()) {
    Cursor key_at = c;
    if (!scan_string(c, nullptr)) return false;
    const long klen = c.p - key_at.p;
    const bool k_image = klen == 7 && !std::memcmp(key_at.p, "\"image\"", 7);
    const bool k_convs =
        klen == 15 && !std::memcmp(key_at.p, "\"conversations\"", 15);
    c.skip_ws();
    if (!c.ok() || c.peek() != ':') return false;
    ++c.p;
    c.skip_ws();
    if (k_image) {
      has_image = !(c.ok() && c.peek() == 'n');  // any value but null
      if (!skip_value(c)) return false;
    } else if (k_convs && c.ok() && c.peek() == '[') {
      ++c.p;
      c.skip_ws();
      if (c.ok() && c.peek() == ']') {
        ++c.p;
      } else {
        while (c.ok()) {
          if (!scan_turn(c, &words)) return false;
          c.skip_ws();
          if (!c.ok()) return false;
          if (c.peek() == ',') { ++c.p; continue; }
          if (c.peek() == ']') { ++c.p; break; }
          return false;
        }
      }
    } else {
      if (!skip_value(c)) return false;
    }
    c.skip_ws();
    if (!c.ok()) return false;
    if (c.peek() == ',') { ++c.p; c.skip_ws(); continue; }
    if (c.peek() == '}') break;
    return false;
  }
  if (words < 1) words = 1;
  *out = has_image ? words : -words;
  return true;
}

}  // namespace

extern "C" {

// One pass over the JSONL at `path`; writes up to `capacity` sign-coded word
// counts into out. Returns the number of lines, or -1 (open failed),
// -2 (capacity too small), -3 (malformed line). Call with out=nullptr to get
// the line count (same contract as jsonl_index).
long modality_lengths(const char* path, int32_t* out, long capacity) {
  if (out == nullptr) return jsonl_index(path, nullptr, 0);
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  long count = 0;
  std::vector<char> line;
  std::vector<char> buf(1 << 20);
  size_t got;
  while ((got = std::fread(buf.data(), 1, buf.size(), f)) > 0) {
    size_t start = 0;
    for (size_t i = 0; i < got; ++i) {
      if (buf[i] != '\n') continue;
      int32_t v;
      bool ok;
      if (line.empty()) {
        ok = modality_length_line(buf.data() + start, buf.data() + i, &v);
      } else {
        line.insert(line.end(), buf.data() + start, buf.data() + i);
        ok = modality_length_line(line.data(), line.data() + line.size(), &v);
        line.clear();
      }
      if (!ok) { std::fclose(f); return -3; }
      if (count >= capacity) { std::fclose(f); return -2; }
      out[count++] = v;
      start = i + 1;
    }
    line.insert(line.end(), buf.data() + start, buf.data() + got);
  }
  std::fclose(f);
  if (!line.empty()) {  // trailing record without newline
    int32_t v;
    if (!modality_length_line(line.data(), line.data() + line.size(), &v))
      return -3;
    if (count >= capacity) return -2;
    out[count++] = v;
  }
  return count;
}

}  // extern "C"

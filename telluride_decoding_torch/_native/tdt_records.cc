// Native TFRecord + tf.train.Example codec (the data-loader hot path).
//
// Copy of telluride_decoding_tpu/_native/tdt_records.cc, so that files
// written by either package are byte-identical. The reference pays its
// dominant ingest cost in a per-frame Python loop building one
// tf.train.Example per record (ingest.py:1118-1172), and reads through
// tf.data. This library provides the native-speed equivalents used by
// telluride_decoding_torch.data.records (ctypes binding; built at first
// use by telluride_decoding_torch._native, which raises if it cannot):
//
//   * crc32c (slice-by-8) + masked variant (TFRecord framing checksums)
//   * record scanning/validation over a whole mapped file
//   * batch decoding of one float feature across all frame-per-record
//     Examples into a contiguous [N, width] buffer
//   * batch encoding of a whole frame-per-record file (all features,
//     all frames) into one output buffer
//
// Build: g++ -O3 -shared -fPIC -std=c++17 tdt_records.cc -o libtdt_records.so

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

uint32_t kCrcTable[8][256];

struct CrcTableBuilder {
  CrcTableBuilder() {
    const uint32_t poly = 0x82F63B78u;  // CRC-32C reflected.
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = i;
      for (int k = 0; k < 8; ++k)
        crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
      kCrcTable[0][i] = crc;
    }
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = kCrcTable[0][i];
      for (int t = 1; t < 8; ++t) {
        crc = (crc >> 8) ^ kCrcTable[0][crc & 0xFF];
        kCrcTable[t][i] = crc;
      }
    }
  }
};

void InitCrcTables() {
  // Thread-safe one-time init (ctypes calls release the GIL, so two
  // Python threads can race a plain flag): C++ guarantees static
  // locals initialize exactly once.
  static CrcTableBuilder builder;
  (void)builder;
}

uint32_t Crc32c(const uint8_t* data, int64_t size, uint32_t crc = 0) {
  InitCrcTables();
  crc ^= 0xFFFFFFFFu;
  while (size >= 8) {
    uint64_t word;
    std::memcpy(&word, data, 8);
    word ^= crc;
    crc = kCrcTable[7][word & 0xFF] ^
          kCrcTable[6][(word >> 8) & 0xFF] ^
          kCrcTable[5][(word >> 16) & 0xFF] ^
          kCrcTable[4][(word >> 24) & 0xFF] ^
          kCrcTable[3][(word >> 32) & 0xFF] ^
          kCrcTable[2][(word >> 40) & 0xFF] ^
          kCrcTable[1][(word >> 48) & 0xFF] ^
          kCrcTable[0][(word >> 56) & 0xFF];
    data += 8;
    size -= 8;
  }
  while (size-- > 0) crc = (crc >> 8) ^ kCrcTable[0][(crc ^ *data++) & 0xFF];
  return crc ^ 0xFFFFFFFFu;
}

uint32_t MaskedCrc(const uint8_t* data, int64_t size) {
  uint32_t crc = Crc32c(data, size);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

// Protobuf wire helpers -------------------------------------------------------

bool ReadVarint(const uint8_t* buf, int64_t size, int64_t* pos,
                uint64_t* value) {
  uint64_t result = 0;
  int shift = 0;
  while (*pos < size && shift < 64) {
    uint8_t byte = buf[(*pos)++];
    result |= static_cast<uint64_t>(byte & 0x7F) << shift;
    if (!(byte & 0x80)) {
      *value = result;
      return true;
    }
    shift += 7;
  }
  return false;
}

bool SkipField(const uint8_t* buf, int64_t size, int64_t* pos,
               uint64_t tag) {
  uint64_t tmp;
  switch (tag & 7) {
    case 0: return ReadVarint(buf, size, pos, &tmp);
    case 1: *pos += 8; return *pos <= size;
    case 2:
      if (!ReadVarint(buf, size, pos, &tmp)) return false;
      // Overflow-safe: a huge corrupt length must not wrap *pos
      // negative (which would pass the <= size check and read out of
      // bounds later).
      if (tmp > static_cast<uint64_t>(size - *pos)) return false;
      *pos += static_cast<int64_t>(tmp);
      return true;
    case 5: *pos += 4; return *pos <= size;
    default: return false;
  }
}

// Finds the float payload of feature `name` inside one Example.
// Returns count of floats (and *out points into buf) or -1.
int64_t FindFloatFeature(const uint8_t* buf, int64_t size,
                         const char* name, int64_t name_len,
                         const float** out) {
  int64_t pos = 0;
  uint64_t tag, len;
  while (pos < size) {
    if (!ReadVarint(buf, size, &pos, &tag)) return -1;
    if ((tag >> 3) == 1 && (tag & 7) == 2) {  // Example.features
      if (!ReadVarint(buf, size, &pos, &len)) return -1;
      // Every embedded length must stay inside its enclosing bound:
      // this buffer is one record's payload, and trusting a corrupt
      // length would walk past the heap allocation (the scan layer
      // only validates FRAMING, and the read path skips even that).
      if (len > static_cast<uint64_t>(size - pos)) return -1;
      int64_t fend = pos + static_cast<int64_t>(len);
      while (pos < fend) {                    // Features.feature entries
        uint64_t etag, elen;
        if (!ReadVarint(buf, fend, &pos, &etag)) return -1;
        if ((etag >> 3) != 1 || (etag & 7) != 2) {
          if (!SkipField(buf, fend, &pos, etag)) return -1;
          continue;
        }
        if (!ReadVarint(buf, fend, &pos, &elen)) return -1;
        if (elen > static_cast<uint64_t>(fend - pos)) return -1;
        int64_t eend = pos + static_cast<int64_t>(elen);
        // Map entry: key (field 1), value Feature (field 2).
        bool key_matches = false;
        int64_t value_pos = -1, value_len = 0;
        while (pos < eend) {
          uint64_t mtag, mlen;
          if (!ReadVarint(buf, eend, &pos, &mtag)) return -1;
          if ((mtag & 7) != 2) {
            if (!SkipField(buf, eend, &pos, mtag)) return -1;
            continue;
          }
          if (!ReadVarint(buf, eend, &pos, &mlen)) return -1;
          if (mlen > static_cast<uint64_t>(eend - pos)) return -1;
          if ((mtag >> 3) == 1) {
            key_matches = (static_cast<int64_t>(mlen) == name_len &&
                           std::memcmp(buf + pos, name, name_len) == 0);
          } else if ((mtag >> 3) == 2) {
            value_pos = pos;
            value_len = static_cast<int64_t>(mlen);
          }
          pos += static_cast<int64_t>(mlen);
        }
        if (key_matches && value_pos >= 0) {
          // Feature -> float_list (field 2) -> packed values (field 1).
          int64_t vp = value_pos;
          int64_t vend = value_pos + value_len;
          uint64_t vtag, vlen;
          while (vp < vend) {
            if (!ReadVarint(buf, vend, &vp, &vtag)) return -1;
            if ((vtag >> 3) == 2 && (vtag & 7) == 2) {  // float_list
              if (!ReadVarint(buf, vend, &vp, &vlen)) return -1;
              if (vlen > static_cast<uint64_t>(vend - vp)) return -1;
              int64_t lp = vp;
              int64_t lend = vp + static_cast<int64_t>(vlen);
              uint64_t ltag, llen;
              while (lp < lend) {
                if (!ReadVarint(buf, lend, &lp, &ltag)) return -1;
                if ((ltag >> 3) == 1 && (ltag & 7) == 2) {  // packed
                  if (!ReadVarint(buf, lend, &lp, &llen)) return -1;
                  if (llen > static_cast<uint64_t>(lend - lp)) return -1;
                  *out = reinterpret_cast<const float*>(buf + lp);
                  return static_cast<int64_t>(llen / 4);
                }
                if (!SkipField(buf, lend, &lp, ltag)) return -1;
              }
              return 0;
            }
            if (!SkipField(buf, vend, &vp, vtag)) return -1;
          }
          return 0;
        }
      }
      pos = fend;
    } else {
      if (!SkipField(buf, size, &pos, tag)) return -1;
    }
  }
  return 0;
}

// Validates one record's wire structure to the depth that
// tf.train.Example.FromString parses (Example -> Features -> map
// entry -> Feature -> value list), and summarizes its schema:
// *nfeat = number of map entries, *keyhash = order-independent hash
// of the entry keys (so renamed/extra/missing features change it).
bool ValidateExample(const uint8_t* buf, int64_t size, int64_t* nfeat,
                     int64_t* keyhash) {
  *nfeat = 0;
  *keyhash = 0;
  int64_t pos = 0;
  uint64_t tag, len;
  while (pos < size) {
    if (!ReadVarint(buf, size, &pos, &tag)) return false;
    if ((tag >> 3) != 1 || (tag & 7) != 2) {
      if (!SkipField(buf, size, &pos, tag)) return false;
      continue;
    }
    if (!ReadVarint(buf, size, &pos, &len)) return false;
    if (len > static_cast<uint64_t>(size - pos)) return false;
    int64_t fend = pos + static_cast<int64_t>(len);
    while (pos < fend) {                     // Features.feature
      uint64_t etag, elen;
      if (!ReadVarint(buf, fend, &pos, &etag)) return false;
      if ((etag >> 3) != 1 || (etag & 7) != 2) {
        if (!SkipField(buf, fend, &pos, etag)) return false;
        continue;
      }
      if (!ReadVarint(buf, fend, &pos, &elen)) return false;
      if (elen > static_cast<uint64_t>(fend - pos)) return false;
      int64_t eend = pos + static_cast<int64_t>(elen);
      ++*nfeat;
      while (pos < eend) {                   // map entry fields
        uint64_t mtag, mlen;
        if (!ReadVarint(buf, eend, &pos, &mtag)) return false;
        if ((mtag & 7) != 2) {
          if (!SkipField(buf, eend, &pos, mtag)) return false;
          continue;
        }
        if (!ReadVarint(buf, eend, &pos, &mlen)) return false;
        if (mlen > static_cast<uint64_t>(eend - pos)) return false;
        if ((mtag >> 3) == 1) {              // key: hash the bytes.
          uint64_t h = 1469598103934665603ull;
          for (uint64_t i = 0; i < mlen; ++i)
            h = (h ^ buf[pos + i]) * 1099511628211ull;
          // Accumulate in unsigned space: summing several 63-bit
          // terms overflows int64_t (UB); uint64_t wrap is defined
          // and the schema comparison only needs consistency.
          *keyhash = static_cast<int64_t>(
              static_cast<uint64_t>(*keyhash) +
              (h & 0x7FFFFFFFFFFFFFFFull));
        } else if ((mtag >> 3) == 2) {       // value: Feature message.
          int64_t vp = pos;
          int64_t vend = pos + static_cast<int64_t>(mlen);
          while (vp < vend) {
            uint64_t vtag, vlen;
            if (!ReadVarint(buf, vend, &vp, &vtag)) return false;
            if ((vtag & 7) == 2) {           // one of the value lists
              if (!ReadVarint(buf, vend, &vp, &vlen)) return false;
              if (vlen > static_cast<uint64_t>(vend - vp))
                return false;
              vp += static_cast<int64_t>(vlen);
            } else if (!SkipField(buf, vend, &vp, vtag)) {
              return false;
            }
          }
        }
        pos += static_cast<int64_t>(mlen);
      }
    }
    pos = fend;
  }
  return true;
}

void AppendVarint(std::string* out, uint64_t value) {
  while (true) {
    uint8_t bits = value & 0x7F;
    value >>= 7;
    if (value) {
      out->push_back(static_cast<char>(bits | 0x80));
    } else {
      out->push_back(static_cast<char>(bits));
      return;
    }
  }
}

}  // namespace

extern "C" {

uint32_t tdt_crc32c(const uint8_t* data, int64_t size) {
  return Crc32c(data, size);
}

uint32_t tdt_masked_crc32c(const uint8_t* data, int64_t size) {
  return MaskedCrc(data, size);
}

// Scans TFRecord framing. Fills offsets/lengths (record payloads) up to
// capacity. Returns record count, or -(bad_offset+1) on corruption.
int64_t tdt_scan_records(const uint8_t* data, int64_t size, int validate,
                         int64_t* offsets, int64_t* lengths,
                         int64_t capacity) {
  int64_t pos = 0;
  int64_t count = 0;
  while (pos < size) {
    if (pos + 12 > size) return -(pos + 1);
    uint64_t len;
    std::memcpy(&len, data + pos, 8);
    // Reject lengths that cannot fit the file: guards against signed
    // overflow in the bounds arithmetic below (a corrupt length like
    // 0xFFFFFFFFFFFFFFF0 would otherwise wrap negative and either
    // read out of bounds or loop forever).
    if (len > static_cast<uint64_t>(size)) return -(pos + 1);
    if (validate) {
      uint32_t want;
      std::memcpy(&want, data + pos + 8, 4);
      if (MaskedCrc(data + pos, 8) != want) return -(pos + 1);
    }
    int64_t payload = pos + 12;
    if (payload + static_cast<int64_t>(len) + 4 > size) return -(pos + 1);
    if (validate) {
      uint32_t want;
      std::memcpy(&want, data + payload + len, 4);
      if (MaskedCrc(data + payload, len) != want) return -(pos + 1);
    }
    if (count < capacity) {
      offsets[count] = payload;
      lengths[count] = static_cast<int64_t>(len);
    }
    ++count;
    pos = payload + static_cast<int64_t>(len) + 4;
  }
  return count;
}

// Validates `num` records as parseable Examples and summarizes each
// record's schema (feature count + key hash). Returns num on success
// or the index of the first malformed record.
int64_t tdt_validate_examples(const uint8_t* data, const int64_t* offsets,
                              const int64_t* lengths, int64_t num,
                              int64_t* nfeat, int64_t* keyhash) {
  for (int64_t r = 0; r < num; ++r) {
    if (!ValidateExample(data + offsets[r], lengths[r], &nfeat[r],
                         &keyhash[r]))
      return r;
  }
  return num;
}

// Decodes feature `name` from `num` records into out [num, width].
// STRICT: a row whose feature is missing, unpacked, or not exactly
// `width` floats fails the whole call (returns -(row+2)) so the caller
// falls back to the tolerant pure-Python parser instead of silently
// zero-filling. Malformed protos return -1.
int64_t tdt_read_feature(const uint8_t* data, const int64_t* offsets,
                         const int64_t* lengths, int64_t num,
                         const char* name, float* out, int64_t width) {
  int64_t name_len = static_cast<int64_t>(std::strlen(name));
  for (int64_t r = 0; r < num; ++r) {
    const float* values = nullptr;
    int64_t got = FindFloatFeature(data + offsets[r], lengths[r], name,
                                   name_len, &values);
    if (got < 0) return -1;
    if (got != width || values == nullptr) return -(r + 2);
    std::memcpy(out + r * width, values, width * 4);
  }
  return num;
}

// Computes the exact output size of tdt_encode_file for sizing.
int64_t tdt_encoded_size(const int64_t* name_lens, const int64_t* widths,
                         int64_t num_features, int64_t num_frames) {
  // Per frame: one record. Compute one example's byte size.
  auto varint_size = [](uint64_t v) {
    int64_t n = 1;
    while (v >= 0x80) { v >>= 7; ++n; }
    return n;
  };
  int64_t body = 0;
  for (int64_t f = 0; f < num_features; ++f) {
    int64_t payload = widths[f] * 4;
    int64_t float_list = 1 + varint_size(payload) + payload;
    int64_t feature = 1 + varint_size(float_list) + float_list;
    int64_t entry = (1 + varint_size(name_lens[f]) + name_lens[f]) +
                    (1 + varint_size(feature) + feature);
    body += 1 + varint_size(entry) + entry;
  }
  int64_t example = 1 + varint_size(body) + body;
  return num_frames * (12 + example + 4);
}

// Encodes num_frames frame-per-record Examples into out.
// names: concatenated names; name_lens/widths per feature;
// data[f] points to [num_frames, widths[f]] float32 row-major.
int64_t tdt_encode_file(const char* names, const int64_t* name_lens,
                        const int64_t* widths, const float** data,
                        int64_t num_features, int64_t num_frames,
                        uint8_t* out, int64_t out_capacity) {
  std::vector<const char*> name_ptrs(num_features);
  {
    const char* p = names;
    for (int64_t f = 0; f < num_features; ++f) {
      name_ptrs[f] = p;
      p += name_lens[f];
    }
  }
  std::string example;
  int64_t pos = 0;
  for (int64_t row = 0; row < num_frames; ++row) {
    example.clear();
    std::string body;
    for (int64_t f = 0; f < num_features; ++f) {
      int64_t payload = widths[f] * 4;
      std::string float_list;
      AppendVarint(&float_list, (1 << 3) | 2);  // FloatList.value packed
      AppendVarint(&float_list, payload);
      float_list.append(
          reinterpret_cast<const char*>(data[f] + row * widths[f]),
          payload);
      std::string feature;
      AppendVarint(&feature, (2 << 3) | 2);     // Feature.float_list
      AppendVarint(&feature, float_list.size());
      feature += float_list;
      std::string entry;
      AppendVarint(&entry, (1 << 3) | 2);       // key
      AppendVarint(&entry, name_lens[f]);
      entry.append(name_ptrs[f], name_lens[f]);
      AppendVarint(&entry, (2 << 3) | 2);       // value
      AppendVarint(&entry, feature.size());
      entry += feature;
      AppendVarint(&body, (1 << 3) | 2);        // Features.feature
      AppendVarint(&body, entry.size());
      body += entry;
    }
    AppendVarint(&example, (1 << 3) | 2);       // Example.features
    AppendVarint(&example, body.size());
    example += body;

    int64_t rec_size = 12 + static_cast<int64_t>(example.size()) + 4;
    if (pos + rec_size > out_capacity) return -1;
    uint64_t len = example.size();
    std::memcpy(out + pos, &len, 8);
    uint32_t len_crc = MaskedCrc(out + pos, 8);
    std::memcpy(out + pos + 8, &len_crc, 4);
    std::memcpy(out + pos + 12, example.data(), example.size());
    uint32_t data_crc = MaskedCrc(out + pos + 12, example.size());
    std::memcpy(out + pos + 12 + example.size(), &data_crc, 4);
    pos += rec_size;
  }
  return pos;
}

}  // extern "C"

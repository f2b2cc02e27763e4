// Shared plugin-side glue: profile parsing + RSCodec -> ec_codec_t adapter.

#pragma once

#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <string>

#include "ec_api.h"
#include "rs.h"

namespace ceph_tpu {

using Profile = std::map<std::string, std::string>;

inline Profile parse_profile(const char* const* keys, const char* const* values,
                             int n) {
  Profile p;
  for (int i = 0; i < n; ++i) p[keys[i]] = values[i];
  return p;
}

inline int profile_int(const Profile& p, const char* key, int dflt) {
  auto it = p.find(key);
  if (it == p.end() || it->second.empty()) return dflt;
  return std::stoi(it->second);
}

struct CodecImpl {
  std::unique_ptr<RSCodec> rs;
};

inline int impl_get_k(ec_codec_t* c) {
  return static_cast<CodecImpl*>(c->impl)->rs->k();
}
inline int impl_get_m(ec_codec_t* c) {
  return static_cast<CodecImpl*>(c->impl)->rs->m();
}
inline size_t impl_chunk_size(ec_codec_t* c, size_t object_size) {
  return static_cast<CodecImpl*>(c->impl)->rs->chunk_size(object_size);
}
inline int impl_encode(ec_codec_t* c, const uint8_t* const* data,
                       uint8_t* const* parity, size_t chunk_len) {
  static_cast<CodecImpl*>(c->impl)->rs->encode(data, parity, chunk_len);
  return 0;
}
inline int impl_decode(ec_codec_t* c, const int* sources,
                       const uint8_t* const* source_data, int ntargets,
                       const int* targets, uint8_t* const* target_data,
                       size_t chunk_len) {
  auto* impl = static_cast<CodecImpl*>(c->impl);
  std::vector<int> src(sources, sources + impl->rs->k());
  std::vector<int> tgt(targets, targets + ntargets);
  try {
    impl->rs->decode(src, source_data, tgt, target_data, chunk_len);
  } catch (const std::exception&) {
    return -5;  // EIO
  }
  return 0;
}
inline void impl_destroy(ec_codec_t* c) {
  delete static_cast<CodecImpl*>(c->impl);
  delete c;
}

inline const ec_codec_ops_t kRsOps = {
    impl_get_k, impl_get_m, impl_chunk_size,
    impl_encode, impl_decode, impl_destroy,
};

inline ec_codec_t* make_codec(std::unique_ptr<RSCodec> rs) {
  auto* impl = new CodecImpl{std::move(rs)};
  auto* c = new ec_codec_t{&kRsOps, impl};
  return c;
}

}  // namespace ceph_tpu

// C ABI for erasure-code plugins — the native dlopen contract.
//
// Mirrors the reference's plugin seam (reference
// src/erasure-code/ErasureCodePlugin.h:24-79): each plugin is a
// libec_<name>.so exporting
//
//   const char* __erasure_code_version(void);     // must equal ABI version
//   int __erasure_code_init(const char* name, void* registry);
//
// and __erasure_code_init must call ec_registry_add(registry, name,
// factory, user).  Version mismatch => -EXDEV; init that does not register
// => -EBADF (same error discipline the reference tests enforce).

#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define CEPH_TPU_EC_ABI_VERSION "0.1.0"

typedef struct ec_codec ec_codec_t;

typedef struct ec_codec_ops {
  int (*get_k)(ec_codec_t*);
  int (*get_m)(ec_codec_t*);
  size_t (*chunk_size)(ec_codec_t*, size_t object_size);
  // parity[i] for i < m, each chunk_len bytes, from data[j] for j < k
  int (*encode)(ec_codec_t*, const uint8_t* const* data,
                uint8_t* const* parity, size_t chunk_len);
  // reconstruct `ntargets` chunks (global ids) from k source chunks
  // (ascending global ids in `sources`)
  int (*decode)(ec_codec_t*, const int* sources,
                const uint8_t* const* source_data, int ntargets,
                const int* targets, uint8_t* const* target_data,
                size_t chunk_len);
  void (*destroy)(ec_codec_t*);
} ec_codec_ops_t;

struct ec_codec {
  const ec_codec_ops_t* ops;
  void* impl;
};

// profile as parallel key/value arrays; returns NULL + sets err on failure
typedef ec_codec_t* (*ec_factory_fn)(const char* const* keys,
                                     const char* const* values, int n,
                                     char* err, size_t err_len, void* user);

// registry (opaque to plugins)
int ec_registry_add(void* registry, const char* name, ec_factory_fn factory,
                    void* user);

#ifdef __cplusplus
}
#endif

// libec_jerasure.so — native jerasure-equivalent plugin.
//
// Techniques: reed_sol_van (default) and reed_sol_r6_op, byte-identical to
// the Python oracle and the reference's jerasure matrices.  The bit-matrix
// techniques (cauchy_*, liberation family) live in the Python plugin and
// the TPU path; the native benchmark A/Bs the matrix codes.

#include <cstring>

#include "plugin_common.h"

using namespace ceph_tpu;

static ec_codec_t* jerasure_factory(const char* const* keys,
                                    const char* const* values, int n,
                                    char* err, size_t err_len, void*) {
  try {
    Profile p = parse_profile(keys, values, n);
    int k = profile_int(p, "k", 2);
    int m = profile_int(p, "m", 1);
    std::string technique =
        p.count("technique") ? p["technique"] : "reed_sol_van";
    Matrix coding;
    if (technique == "reed_sol_van") {
      coding = vandermonde_coding_matrix(k, m);
    } else if (technique == "reed_sol_r6_op") {
      m = 2;
      coding = r6_coding_matrix(k);
    } else if (technique == "cauchy_orig") {
      // native cauchy encodes byte-wise with the cauchy matrix (the packet
      // bit-matrix layout is the Python/TPU plugin's domain)
      coding = cauchy_orig_matrix(k, m);
    } else {
      snprintf(err, err_len, "technique %s not supported natively",
               technique.c_str());
      return nullptr;
    }
    return make_codec(std::make_unique<RSCodec>(k, m, std::move(coding)));
  } catch (const std::exception& e) {
    snprintf(err, err_len, "%s", e.what());
    return nullptr;
  }
}

extern "C" {
const char* __erasure_code_version() { return CEPH_TPU_EC_ABI_VERSION; }
int __erasure_code_init(const char* name, void* registry) {
  return ec_registry_add(registry, name, jerasure_factory, nullptr);
}
}

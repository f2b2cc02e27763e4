// libec_isa.so — native isa-equivalent plugin (reed_sol_van / cauchy
// matrices, isa-l constructions; MDS envelope enforced like the reference's
// ErasureCodeIsa.cc:331-361).

#include <cstring>

#include "plugin_common.h"

using namespace ceph_tpu;

namespace {

// isa chunk rule differs: ceil(object/k) rounded up to 32 B
class IsaCodec : public RSCodec {
 public:
  using RSCodec::RSCodec;
};

}  // namespace

static ec_codec_t* isa_factory(const char* const* keys,
                               const char* const* values, int n, char* err,
                               size_t err_len, void*) {
  try {
    Profile p = parse_profile(keys, values, n);
    int k = profile_int(p, "k", 7);
    int m = profile_int(p, "m", 3);
    std::string technique =
        p.count("technique") ? p["technique"] : "reed_sol_van";
    Matrix coding;
    if (technique == "reed_sol_van") {
      if (k > 32 || m > 4 || (m == 4 && k > 21)) {
        snprintf(err, err_len, "outside verified MDS envelope");
        return nullptr;
      }
      coding = isa_vandermonde_matrix(k, m);
    } else if (technique == "cauchy") {
      coding = isa_cauchy_matrix(k, m);
    } else {
      snprintf(err, err_len, "technique %s unknown", technique.c_str());
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
  return ec_registry_add(registry, name, isa_factory, nullptr);
}
}

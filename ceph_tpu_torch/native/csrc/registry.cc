// Native plugin registry: dlopen + version handshake + factory.
//
// Reference behaviors reproduced (src/erasure-code/ErasureCodePlugin.cc):
//   * loads <dir>/libec_<name>.so with RTLD_NOW (:120-178);
//   * missing __erasure_code_version / __erasure_code_init => -ENOENT;
//   * version mismatch => -EXDEV (:141-153);
//   * init that does not register => -EBADF;
//   * the registry mutex is held across load (a hanging plugin blocks —
//     the reference proves this with TestErasureCodePlugin's factory_mutex).

#include <dlfcn.h>
#include <errno.h>
#include <string.h>

#include <map>
#include <mutex>
#include <string>

#include "ec_api.h"

namespace {

struct Plugin {
  ec_factory_fn factory;
  void* user;
};

struct Registry {
  std::mutex lock;
  std::map<std::string, Plugin> plugins;
};

Registry g_registry;

int load_locked(const std::string& name, const std::string& dir) {
  std::string path = dir.empty() ? ("libec_" + name + ".so")
                                 : (dir + "/libec_" + name + ".so");
  void* handle = dlopen(path.c_str(), RTLD_NOW | RTLD_LOCAL);
  if (!handle) return -ENOENT;
  using version_fn = const char* (*)();
  using init_fn = int (*)(const char*, void*);
  auto version = reinterpret_cast<version_fn>(
      dlsym(handle, "__erasure_code_version"));
  if (!version) { dlclose(handle); return -ENOENT; }
  if (strcmp(version(), CEPH_TPU_EC_ABI_VERSION) != 0) {
    dlclose(handle);
    return -EXDEV;
  }
  auto init = reinterpret_cast<init_fn>(dlsym(handle, "__erasure_code_init"));
  if (!init) { dlclose(handle); return -ENOENT; }
  int rc = init(name.c_str(), &g_registry);
  if (rc != 0) { dlclose(handle); return rc; }
  if (g_registry.plugins.find(name) == g_registry.plugins.end()) {
    dlclose(handle);
    return -EBADF;  // init did not register itself
  }
  return 0;  // handle intentionally leaked: plugins stay loaded (reference
             // keeps them until registry shutdown; disable_dlclose parity)
}

}  // namespace

extern "C" {

int ec_registry_add(void* registry, const char* name, ec_factory_fn factory,
                    void* user) {
  auto* reg = static_cast<Registry*>(registry);
  if (reg->plugins.count(name)) return -EEXIST;
  reg->plugins[name] = Plugin{factory, user};
  return 0;
}

// factory(): THE consumer entry point (load if needed, then instantiate)
ec_codec_t* ec_registry_factory(const char* name, const char* dir,
                                const char* const* keys,
                                const char* const* values, int n, char* err,
                                size_t err_len, int* rc_out) {
  std::lock_guard<std::mutex> g(g_registry.lock);
  auto it = g_registry.plugins.find(name);
  if (it == g_registry.plugins.end()) {
    int rc = load_locked(name, dir ? dir : "");
    if (rc != 0) {
      if (rc_out) *rc_out = rc;
      if (err && err_len) snprintf(err, err_len, "load %s failed (%d)", name, rc);
      return nullptr;
    }
    it = g_registry.plugins.find(name);
  }
  if (rc_out) *rc_out = 0;
  return it->second.factory(keys, values, n, err, err_len, it->second.user);
}

}  // extern "C"

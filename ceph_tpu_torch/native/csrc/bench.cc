// ceph_erasure_code_benchmark — reference-compatible measurement CLI.
//
// Same protocol as the reference tool (src/test/erasure-code/
// ceph_erasure_code_benchmark.cc): encode --size bytes per iteration,
// print "<seconds>\t<KB processed>"; decode workload erases chunks per
// iteration and reconstructs.  Flags: --plugin/-p, --workload/-w,
// --iterations/-i, --size/-s, --erasures/-e, --parameter/-P k=v,
// --directory/-d.  MB/s = (size*iterations/2^20)/seconds, as bench.sh
// computes (qa/workunits/erasure-code/bench.sh:170).

#include <getopt.h>

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <string>
#include <vector>

#include "ec_api.h"

extern "C" ec_codec_t* ec_registry_factory(const char* name, const char* dir,
                                           const char* const* keys,
                                           const char* const* values, int n,
                                           char* err, size_t err_len,
                                           int* rc_out);

int main(int argc, char** argv) {
  std::string plugin = "jerasure", workload = "encode", dir = ".";
  long iterations = 1;
  size_t size = 1 << 20;
  int erasures = 1;
  std::vector<std::string> pkeys, pvalues;

  static option opts[] = {
      {"plugin", required_argument, nullptr, 'p'},
      {"workload", required_argument, nullptr, 'w'},
      {"iterations", required_argument, nullptr, 'i'},
      {"size", required_argument, nullptr, 's'},
      {"erasures", required_argument, nullptr, 'e'},
      {"parameter", required_argument, nullptr, 'P'},
      {"directory", required_argument, nullptr, 'd'},
      {nullptr, 0, nullptr, 0},
  };
  int c;
  while ((c = getopt_long(argc, argv, "p:w:i:s:e:P:d:", opts, nullptr)) != -1) {
    switch (c) {
      case 'p': plugin = optarg; break;
      case 'w': workload = optarg; break;
      case 'i': iterations = atol(optarg); break;
      case 's': size = strtoull(optarg, nullptr, 10); break;
      case 'e': erasures = atoi(optarg); break;
      case 'd': dir = optarg; break;
      case 'P': {
        std::string kv = optarg;
        auto eq = kv.find('=');
        if (eq == std::string::npos) {
          fprintf(stderr, "-P expects key=value\n");
          return 1;
        }
        pkeys.push_back(kv.substr(0, eq));
        pvalues.push_back(kv.substr(eq + 1));
        break;
      }
      default: return 1;
    }
  }

  std::vector<const char*> keys, values;
  for (auto& s : pkeys) keys.push_back(s.c_str());
  for (auto& s : pvalues) values.push_back(s.c_str());
  char err[256] = {0};
  int rc = 0;
  ec_codec_t* codec = ec_registry_factory(
      plugin.c_str(), dir.c_str(), keys.data(), values.data(),
      static_cast<int>(keys.size()), err, sizeof(err), &rc);
  if (!codec) {
    fprintf(stderr, "factory(%s) failed: %s (%d)\n", plugin.c_str(), err, rc);
    return 1;
  }

  int k = codec->ops->get_k(codec);
  int m = codec->ops->get_m(codec);
  size_t chunk = codec->ops->chunk_size(codec, size);

  std::mt19937_64 rng(42);
  std::vector<std::vector<uint8_t>> data(k, std::vector<uint8_t>(chunk));
  for (auto& d : data)
    for (auto& b : d) b = static_cast<uint8_t>(rng());
  std::vector<std::vector<uint8_t>> parity(m, std::vector<uint8_t>(chunk));
  std::vector<const uint8_t*> dptr(k);
  std::vector<uint8_t*> pptr(m);
  for (int i = 0; i < k; ++i) dptr[i] = data[i].data();
  for (int i = 0; i < m; ++i) pptr[i] = parity[i].data();

  double seconds = 0;
  if (workload == "encode") {
    auto t0 = std::chrono::steady_clock::now();
    for (long it = 0; it < iterations; ++it)
      codec->ops->encode(codec, dptr.data(), pptr.data(), chunk);
    seconds = std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
                  .count();
  } else {  // decode: erase `erasures` random chunks, reconstruct
    if (erasures < 1 || erasures > m) {
      fprintf(stderr, "erasures=%d must be in [1, m=%d]\n", erasures, m);
      codec->ops->destroy(codec);
      return 1;
    }
    codec->ops->encode(codec, dptr.data(), pptr.data(), chunk);
    std::vector<const uint8_t*> all(k + m);
    for (int i = 0; i < k; ++i) all[i] = data[i].data();
    for (int i = 0; i < m; ++i) all[k + i] = parity[i].data();
    std::vector<std::vector<uint8_t>> out(erasures,
                                          std::vector<uint8_t>(chunk));
    auto t0 = std::chrono::steady_clock::now();
    for (long it = 0; it < iterations; ++it) {
      std::vector<int> erased;
      while (static_cast<int>(erased.size()) < erasures) {
        int e = static_cast<int>(rng() % (k + m));
        bool dup = false;
        for (int x : erased) dup |= (x == e);
        if (!dup) erased.push_back(e);
      }
      std::vector<int> sources;
      std::vector<const uint8_t*> src;
      for (int i = 0; i < k + m && static_cast<int>(sources.size()) < k; ++i) {
        bool gone = false;
        for (int x : erased) gone |= (x == i);
        if (!gone) {
          sources.push_back(i);
          src.push_back(all[i]);
        }
      }
      std::vector<uint8_t*> optr(erasures);
      for (int i = 0; i < erasures; ++i) optr[i] = out[i].data();
      int rc = codec->ops->decode(codec, sources.data(), src.data(), erasures,
                                  erased.data(), optr.data(), chunk);
      if (rc != 0) {
        fprintf(stderr, "decode failed: rc=%d\n", rc);
        codec->ops->destroy(codec);
        return 1;
      }
    }
    seconds = std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
                  .count();
  }

  // reference output format: "<seconds>\t<KB processed>"
  printf("%f\t%lu\n", seconds,
         static_cast<unsigned long>(size * iterations / 1024));
  codec->ops->destroy(codec);
  return 0;
}

// Reed-Solomon codec over GF(2^8): matrix construction, encode, decode.
//
// Matrix algorithms mirror the reference's jerasure constructions
// (reed_sol_vandermonde_coding_matrix semantics — systematized extended
// Vandermonde with the same elimination order, so coding chunks are
// byte-identical to the Python oracle and to jerasure; and the isa-l
// gf_gen_rs_matrix/gf_gen_cauchy1_matrix variants).

#pragma once

#include <cstdint>
#include <stdexcept>
#include <string>
#include <vector>

namespace ceph_tpu {

using Matrix = std::vector<std::vector<uint8_t>>;

Matrix vandermonde_coding_matrix(int k, int m);          // jerasure reed_sol_van
Matrix r6_coding_matrix(int k);                          // jerasure reed_sol_r6_op
Matrix cauchy_orig_matrix(int k, int m);                 // jerasure cauchy_orig
Matrix isa_vandermonde_matrix(int k, int m);             // isa-l gf_gen_rs_matrix
Matrix isa_cauchy_matrix(int k, int m);                  // isa-l gf_gen_cauchy1
Matrix invert_matrix(const Matrix& a);                   // Gauss-Jordan; throws

class RSCodec {
 public:
  RSCodec(int k, int m, Matrix coding);  // coding: m x k

  int k() const { return k_; }
  int m() const { return m_; }

  // chunk_size rule (jerasure object-alignment semantics: round object to
  // k*w*sizeof(int)=k*32, divide by k)
  size_t chunk_size(size_t object_size) const;

  // parity[i] (i<m), each chunk_len bytes, from data[j] (j<k)
  void encode(const uint8_t* const* data, uint8_t* const* parity,
              size_t chunk_len) const;

  // reconstruct chunks listed in `targets` (global ids 0..k+m-1) from the
  // k source chunks whose global ids are `sources` (ascending)
  void decode(const std::vector<int>& sources,
              const uint8_t* const* source_data,
              const std::vector<int>& targets,
              uint8_t* const* target_data, size_t chunk_len) const;

 private:
  int k_, m_;
  Matrix coding_;  // m x k
};

}  // namespace ceph_tpu

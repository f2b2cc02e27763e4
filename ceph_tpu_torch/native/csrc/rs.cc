#include "rs.h"

#include "gf256.h"

namespace ceph_tpu {

namespace {
const GF256& gf() { return GF256::instance(); }

Matrix extended_vandermonde(int rows, int cols) {
  Matrix vdm(rows, std::vector<uint8_t>(cols, 0));
  vdm[0][0] = 1;
  if (rows == 1) return vdm;
  vdm[rows - 1][cols - 1] = 1;
  if (rows == 2) return vdm;
  for (int i = 1; i < rows - 1; ++i) {
    uint8_t acc = 1;
    for (int j = 0; j < cols; ++j) {
      vdm[i][j] = acc;
      acc = gf().mul(acc, static_cast<uint8_t>(i));
    }
  }
  return vdm;
}
}  // namespace

Matrix vandermonde_coding_matrix(int k, int m) {
  // systematize exactly as the reference's
  // reed_sol_big_vandermonde_distribution_matrix does (column elimination
  // order preserved for byte-exactness)
  int rows = k + m, cols = k;
  if (rows > 256) throw std::invalid_argument("k+m > 256");
  Matrix dist = extended_vandermonde(rows, cols);
  for (int i = 1; i < cols; ++i) {
    int pivot = -1;
    for (int j = i; j < rows; ++j)
      if (dist[j][i]) { pivot = j; break; }
    if (pivot < 0) throw std::runtime_error("cannot systematize");
    if (pivot > i) std::swap(dist[i], dist[pivot]);
    if (dist[i][i] != 1) {
      uint8_t tmp = gf().div(1, dist[i][i]);
      for (int j = 0; j < rows; ++j)
        if (dist[j][i]) dist[j][i] = gf().mul(tmp, dist[j][i]);
    }
    for (int j = 0; j < cols; ++j) {
      uint8_t tmp = dist[i][j];
      if (j != i && tmp != 0)
        for (int r = 0; r < rows; ++r)
          dist[r][j] ^= gf().mul(tmp, dist[r][i]);
    }
  }
  for (int j = 0; j < cols; ++j) {
    uint8_t tmp = dist[cols][j];
    if (tmp != 1) {
      tmp = gf().div(1, tmp);
      for (int i = cols; i < rows; ++i) dist[i][j] = gf().mul(tmp, dist[i][j]);
    }
  }
  for (int i = cols + 1; i < rows; ++i) {
    uint8_t tmp = dist[i][0];
    if (tmp != 1) {
      tmp = gf().div(1, tmp);
      for (int j = 0; j < cols; ++j) dist[i][j] = gf().mul(dist[i][j], tmp);
    }
  }
  Matrix coding(m, std::vector<uint8_t>(k));
  for (int i = 0; i < m; ++i) coding[i] = dist[k + i];
  return coding;
}

Matrix r6_coding_matrix(int k) {
  if (k + 2 > 256) throw std::invalid_argument("k+2 > 256");
  Matrix mat(2, std::vector<uint8_t>(k));
  uint8_t acc = 1;
  for (int j = 0; j < k; ++j) {
    mat[0][j] = 1;
    mat[1][j] = acc;
    acc = gf().mul(acc, 2);
  }
  return mat;
}

Matrix cauchy_orig_matrix(int k, int m) {
  if (k + m > 256) throw std::invalid_argument("k+m > 256");
  Matrix mat(m, std::vector<uint8_t>(k));
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < k; ++j)
      mat[i][j] = gf().div(1, static_cast<uint8_t>(i ^ (m + j)));
  return mat;
}

Matrix isa_vandermonde_matrix(int k, int m) {
  Matrix mat(m, std::vector<uint8_t>(k));
  for (int i = 0; i < m; ++i) {
    uint8_t gen = gf().pow(2, i);
    for (int j = 0; j < k; ++j) mat[i][j] = gf().pow(gen, j);
  }
  return mat;
}

Matrix isa_cauchy_matrix(int k, int m) {
  if (k + m > 256) throw std::invalid_argument("k+m > 256");
  Matrix mat(m, std::vector<uint8_t>(k));
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < k; ++j)
      mat[i][j] = gf().div(1, static_cast<uint8_t>((k + i) ^ j));
  return mat;
}

Matrix invert_matrix(const Matrix& in) {
  size_t n = in.size();
  Matrix a = in;
  Matrix inv(n, std::vector<uint8_t>(n, 0));
  for (size_t i = 0; i < n; ++i) inv[i][i] = 1;
  for (size_t col = 0; col < n; ++col) {
    size_t pivot = col;
    while (pivot < n && a[pivot][col] == 0) ++pivot;
    if (pivot == n) throw std::runtime_error("singular GF matrix");
    if (pivot != col) {
      std::swap(a[col], a[pivot]);
      std::swap(inv[col], inv[pivot]);
    }
    uint8_t p = a[col][col];
    if (p != 1) {
      uint8_t pi = gf().inv(p);
      for (size_t j = 0; j < n; ++j) {
        a[col][j] = gf().mul(pi, a[col][j]);
        inv[col][j] = gf().mul(pi, inv[col][j]);
      }
    }
    for (size_t row = 0; row < n; ++row) {
      uint8_t c = a[row][col];
      if (row != col && c) {
        for (size_t j = 0; j < n; ++j) {
          a[row][j] ^= gf().mul(c, a[col][j]);
          inv[row][j] ^= gf().mul(c, inv[col][j]);
        }
      }
    }
  }
  return inv;
}

RSCodec::RSCodec(int k, int m, Matrix coding)
    : k_(k), m_(m), coding_(std::move(coding)) {
  if (static_cast<int>(coding_.size()) != m_)
    throw std::invalid_argument("coding matrix row count != m");
}

size_t RSCodec::chunk_size(size_t object_size) const {
  size_t alignment = static_cast<size_t>(k_) * 8 * sizeof(int);
  size_t padded =
      object_size ? (object_size + alignment - 1) / alignment * alignment
                  : alignment;
  return padded / k_;
}

void RSCodec::encode(const uint8_t* const* data, uint8_t* const* parity,
                     size_t chunk_len) const {
  // cache-tiled: walk the chunk in L1-sized blocks and apply every
  // coefficient to the resident block, so each parity block is written
  // once from cache instead of being re-streamed from DRAM k times per
  // parity row (the difference between memory-bound at chunk scale and
  // compute-bound at block scale; isa-l interleaves for the same reason)
  constexpr size_t kBlock = 16 * 1024;
  for (size_t off = 0; off < chunk_len; off += kBlock) {
    size_t n = chunk_len - off < kBlock ? chunk_len - off : kBlock;
    for (int i = 0; i < m_; ++i) {
      uint8_t* out = parity[i] + off;
      gf().mul_region(coding_[i][0], data[0] + off, out, n);
      for (int j = 1; j < k_; ++j)
        gf().mul_region_xor(coding_[i][j], data[j] + off, out, n);
    }
  }
}

void RSCodec::decode(const std::vector<int>& sources,
                     const uint8_t* const* source_data,
                     const std::vector<int>& targets,
                     uint8_t* const* target_data, size_t chunk_len) const {
  // rows of [I; G] for the chosen sources, inverted -> data from sources
  Matrix full(k_ + m_, std::vector<uint8_t>(k_, 0));
  for (int i = 0; i < k_; ++i) full[i][i] = 1;
  for (int i = 0; i < m_; ++i) full[k_ + i] = coding_[i];
  Matrix sub(k_, std::vector<uint8_t>(k_));
  for (int i = 0; i < k_; ++i) sub[i] = full[sources[i]];
  Matrix inv = invert_matrix(sub);

  // target row = (target's row of [I;G]) x inv, applied to source regions
  for (size_t t = 0; t < targets.size(); ++t) {
    int tgt = targets[t];
    std::vector<uint8_t> row(k_, 0);
    for (int j = 0; j < k_; ++j) {
      uint8_t acc = 0;
      for (int l = 0; l < k_; ++l)
        acc ^= gf().mul(full[tgt][l], inv[l][j]);
      row[j] = acc;
    }
    uint8_t* out = target_data[t];
    for (size_t b = 0; b < chunk_len; ++b) out[b] = 0;
    for (int j = 0; j < k_; ++j)
      gf().mul_region_xor(row[j], source_data[j], out, chunk_len);
  }
}

}  // namespace ceph_tpu

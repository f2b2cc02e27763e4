// Copy of native/wirepath_py.cc at commit d2d1706, built by
// ceph_tpu_torch/native/bridge.py at first use; its comments leave out
// the reference's issue numbers.
//
// Python-API shims for the native wirepath (loaded via ctypes.PyDLL —
// the GIL is HELD on entry, unlike the plain CDLL entry points in
// wirepath.cc).
//
// Why this file exists: the hot tx path hands the native layer a LIST
// of buffer objects (frame headers, pickled parts, blob views).
// Extracting each buffer's address above, in Python/ctypes, costs
// ~0.5-1.3 µs per segment — more than the syscall it feeds.  Here the
// extraction is a PyObject_GetBuffer walk in C (~100 ns/segment, GIL
// held, no allocation per segment), and the byte work then runs inside
// Py_BEGIN_ALLOW_THREADS — so one call parses the window cheaply AND
// releases the GIL for the writev/crc loops, which is the entire point
// of the wirepath (arXiv:2108.02692's specialize-the-loops
// technique applied to the wire plane).
//
// Built as a SEPARATE shared object (libceph_tpu_wirepy.so): it needs
// Python headers, and the base library must stay loadable — and
// sanitizer-buildable into standalone exes — without them.  Python
// symbols stay undefined at link time and resolve from the hosting
// process at dlopen, the standard extension-module discipline.
//
// Every function returns a plain integer status (never raises, never
// leaves a Python error set): the ctypes side turns negative errno
// values into exceptions.

#include <Python.h>

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <vector>

// the pure entry points this file fans into (wirepath.cc / crc32c.cc,
// compiled into this .so as well so it is self-contained)
extern "C" uint32_t ceph_tpu_crc32c(uint32_t seed, const uint8_t* data,
                                    size_t len);
extern "C" int64_t ceph_tpu_wire_writev(int fd, const uint8_t* const* ptrs,
                                        const size_t* lens, int32_t nseg,
                                        size_t skip);
extern "C" int64_t ceph_tpu_wire_gather(const uint8_t* const* ptrs,
                                        const size_t* lens, int32_t nseg,
                                        uint8_t* out, size_t cap);

namespace {

// Acquire PyBUF_SIMPLE views of every element of a sequence; fills
// ptrs/lens and returns the number acquired (== n on success, with rc
// untouched), or sets rc = -EINVAL on the first non-buffer element.
Py_ssize_t acquire_segments(PyObject* fast, std::vector<Py_buffer>& bufs,
                            std::vector<const uint8_t*>& ptrs,
                            std::vector<size_t>& lens, long long* rc) {
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  bufs.resize(n);
  ptrs.resize(n);
  lens.resize(n);
  Py_ssize_t got = 0;
  for (; got < n; ++got) {
    PyObject* o = PySequence_Fast_GET_ITEM(fast, got);
    if (PyObject_GetBuffer(o, &bufs[got], PyBUF_SIMPLE) != 0) {
      PyErr_Clear();
      *rc = -EINVAL;
      break;
    }
    ptrs[got] = static_cast<const uint8_t*>(bufs[got].buf);
    lens[got] = static_cast<size_t>(bufs[got].len);
  }
  return got;
}

void release_segments(std::vector<Py_buffer>& bufs, Py_ssize_t got) {
  for (Py_ssize_t i = 0; i < got; ++i) PyBuffer_Release(&bufs[i]);
}

}  // namespace

extern "C" {

// writev a whole flush window: one PyDLL call walks the segment list
// in C and drains it onto the nonblocking fd with the GIL released.
// Returns bytes written (0 = would-block) or -errno.
long long ceph_tpu_wirepy_writev(int fd, PyObject* segs,
                                 unsigned long long skip) {
  PyObject* fast = PySequence_Fast(segs, "wirepy_writev segments");
  if (fast == nullptr) {
    PyErr_Clear();
    return -EINVAL;
  }
  std::vector<Py_buffer> bufs;
  std::vector<const uint8_t*> ptrs;
  std::vector<size_t> lens;
  long long rc = 0;
  Py_ssize_t got = acquire_segments(fast, bufs, ptrs, lens, &rc);
  if (rc == 0) {
    Py_BEGIN_ALLOW_THREADS
    rc = ceph_tpu_wire_writev(fd, ptrs.data(), lens.data(),
                              static_cast<int32_t>(got),
                              static_cast<size_t>(skip));
    Py_END_ALLOW_THREADS
  }
  release_segments(bufs, got);
  Py_DECREF(fast);
  return rc;
}

// chained crc32c over a list of buffers (a BufferList's pieces, a
// frame's crc sections): returns the crc (0..2^32-1) or -EINVAL.
long long ceph_tpu_wirepy_crc_chain(PyObject* segs, unsigned int seed) {
  PyObject* fast = PySequence_Fast(segs, "wirepy_crc_chain segments");
  if (fast == nullptr) {
    PyErr_Clear();
    return -EINVAL;
  }
  std::vector<Py_buffer> bufs;
  std::vector<const uint8_t*> ptrs;
  std::vector<size_t> lens;
  long long rc = 0;
  Py_ssize_t got = acquire_segments(fast, bufs, ptrs, lens, &rc);
  if (rc == 0) {
    uint32_t crc = seed;
    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t i = 0; i < got; ++i)
      crc = ceph_tpu_crc32c(crc, ptrs[i], lens[i]);
    Py_END_ALLOW_THREADS
    rc = static_cast<long long>(crc);
  }
  release_segments(bufs, got);
  Py_DECREF(fast);
  return rc;
}

// rx burst verify: regions of ONE buffer (the FrameReceiver backlog)
// against their wire crcs.  offs/lens/wants are plain Python int lists
// built by the frame parse — walking them here costs ~50ns/entry
// against the ~1µs/entry a ctypes array build costs above, and the crc
// loop then runs with the GIL released.  Returns -1 when every region
// matches, the first mismatching index on crc failure, or -EINVAL on
// out-of-bounds geometry / non-int entries (checked BEFORE any read).
long long ceph_tpu_wirepy_verify_regions(PyObject* base, PyObject* offs,
                                         PyObject* lens, PyObject* wants) {
  Py_buffer bb;
  if (PyObject_GetBuffer(base, &bb, PyBUF_SIMPLE) != 0) {
    PyErr_Clear();
    return -EINVAL;
  }
  long long rc = -1;
  PyObject *fo = nullptr, *fl = nullptr, *fw = nullptr;
  std::vector<size_t> o, l;
  std::vector<uint32_t> w;
  do {
    fo = PySequence_Fast(offs, "offs");
    fl = PySequence_Fast(lens, "lens");
    fw = PySequence_Fast(wants, "wants");
    if (!fo || !fl || !fw) {
      PyErr_Clear();
      rc = -EINVAL;
      break;
    }
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fo);
    if (PySequence_Fast_GET_SIZE(fl) != n
        || PySequence_Fast_GET_SIZE(fw) != n) {
      rc = -EINVAL;
      break;
    }
    o.resize(n);
    l.resize(n);
    w.resize(n);
    size_t blen = static_cast<size_t>(bb.len);
    for (Py_ssize_t i = 0; i < n; ++i) {
      long long ov = PyLong_AsLongLong(PySequence_Fast_GET_ITEM(fo, i));
      long long lv = PyLong_AsLongLong(PySequence_Fast_GET_ITEM(fl, i));
      long long wv = PyLong_AsLongLong(PySequence_Fast_GET_ITEM(fw, i));
      if (PyErr_Occurred()) {
        PyErr_Clear();
        rc = -EINVAL;
        break;
      }
      if (ov < 0 || lv < 0 || static_cast<size_t>(ov) > blen
          || static_cast<size_t>(lv) > blen - static_cast<size_t>(ov)
          || wv < 0 || wv > 0xFFFFFFFFLL) {
        rc = -EINVAL;
        break;
      }
      o[i] = static_cast<size_t>(ov);
      l[i] = static_cast<size_t>(lv);
      w[i] = static_cast<uint32_t>(wv);
    }
    if (rc == -EINVAL) break;
    const uint8_t* b = static_cast<const uint8_t*>(bb.buf);
    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t i = 0; i < n; ++i) {
      if (ceph_tpu_crc32c(0, b + o[i], l[i]) != w[i]) {
        rc = i;
        break;
      }
    }
    Py_END_ALLOW_THREADS
  } while (false);
  Py_XDECREF(fo);
  Py_XDECREF(fl);
  Py_XDECREF(fw);
  PyBuffer_Release(&bb);
  return rc;
}

// rx burst scatter: land region i of `base` (at soffs[i], dsts[i]'s
// own length) into writable buffer dsts[i] — a burst's verified frame
// blobs leave the backlog in ONE released-GIL memcpy loop instead of
// one interpreter slice-assign per frame.  Geometry is fully validated
// (source bounds per Python-int offset, writable destination) before
// any byte moves; on refusal NOTHING is copied.  Returns total bytes
// copied or -EINVAL.
long long ceph_tpu_wirepy_scatter_from(PyObject* base, PyObject* soffs,
                                       PyObject* dsts) {
  Py_buffer bb;
  if (PyObject_GetBuffer(base, &bb, PyBUF_SIMPLE) != 0) {
    PyErr_Clear();
    return -EINVAL;
  }
  long long rc = 0;
  PyObject *fo = nullptr, *fd = nullptr;
  std::vector<Py_buffer> bufs;
  std::vector<size_t> offs;
  Py_ssize_t got = 0;
  do {
    fo = PySequence_Fast(soffs, "soffs");
    fd = PySequence_Fast(dsts, "dsts");
    if (!fo || !fd) {
      PyErr_Clear();
      rc = -EINVAL;
      break;
    }
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fd);
    if (PySequence_Fast_GET_SIZE(fo) != n) {
      rc = -EINVAL;
      break;
    }
    bufs.resize(n);
    offs.resize(n);
    size_t blen = static_cast<size_t>(bb.len);
    for (; got < n; ++got) {
      long long ov = PyLong_AsLongLong(PySequence_Fast_GET_ITEM(fo, got));
      if (PyErr_Occurred()) {
        PyErr_Clear();
        rc = -EINVAL;
        break;
      }
      if (PyObject_GetBuffer(PySequence_Fast_GET_ITEM(fd, got),
                             &bufs[got], PyBUF_WRITABLE) != 0) {
        PyErr_Clear();
        rc = -EINVAL;
        break;
      }
      size_t dlen = static_cast<size_t>(bufs[got].len);
      if (ov < 0 || static_cast<size_t>(ov) > blen
          || dlen > blen - static_cast<size_t>(ov)) {
        ++got;  // this view IS acquired; release it below
        rc = -EINVAL;
        break;
      }
      offs[got] = static_cast<size_t>(ov);
    }
    if (rc == -EINVAL) break;
    const uint8_t* b = static_cast<const uint8_t*>(bb.buf);
    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t i = 0; i < n; ++i) {
      if (bufs[i].len)
        std::memcpy(bufs[i].buf, b + offs[i],
                    static_cast<size_t>(bufs[i].len));
      rc += bufs[i].len;
    }
    Py_END_ALLOW_THREADS
  } while (false);
  for (Py_ssize_t i = 0; i < got; ++i) PyBuffer_Release(&bufs[i]);
  Py_XDECREF(fo);
  Py_XDECREF(fd);
  PyBuffer_Release(&bb);
  return rc;
}

// gather a list of buffers into one writable destination buffer:
// returns total bytes or -EINVAL (non-buffer element, readonly or
// undersized destination).
long long ceph_tpu_wirepy_gather(PyObject* segs, PyObject* dst) {
  PyObject* fast = PySequence_Fast(segs, "wirepy_gather segments");
  if (fast == nullptr) {
    PyErr_Clear();
    return -EINVAL;
  }
  Py_buffer out;
  if (PyObject_GetBuffer(dst, &out, PyBUF_WRITABLE) != 0) {
    PyErr_Clear();
    Py_DECREF(fast);
    return -EINVAL;
  }
  std::vector<Py_buffer> bufs;
  std::vector<const uint8_t*> ptrs;
  std::vector<size_t> lens;
  long long rc = 0;
  Py_ssize_t got = acquire_segments(fast, bufs, ptrs, lens, &rc);
  if (rc == 0) {
    Py_BEGIN_ALLOW_THREADS
    rc = ceph_tpu_wire_gather(ptrs.data(), lens.data(),
                              static_cast<int32_t>(got),
                              static_cast<uint8_t*>(out.buf),
                              static_cast<size_t>(out.len));
    Py_END_ALLOW_THREADS
  }
  release_segments(bufs, got);
  PyBuffer_Release(&out);
  Py_DECREF(fast);
  return rc;
}

}  // extern "C"

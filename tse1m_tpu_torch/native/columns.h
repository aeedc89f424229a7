// Shared column accumulators + numpy materialisation for the native
// decoders (decode.cc: sqlite scan; pg_decode.cc: Postgres COPY-binary
// scan), a copy of the JAX package's columns.h.  The two scans read very
// different wire formats, but build the SAME per-spec-char columns and
// materialise them identically, so the Python-side consumers
// (data/columnar.py's CodedColumn/BytesColumn) see one contract.
//
// Include contract: this header is textually included INSIDE each .cc's
// anonymous namespace, AFTER <Python.h>, <numpy/arrayobject.h> and the
// std headers it relies on (<cstdint>, <cstring>, <string>,
// <string_view>, <unordered_map>, <vector>) — it performs no #includes
// of its own so it can live at internal linkage in each translation unit.

// 'o' cell tags.
enum : uint8_t { O_NULL = 0, O_INT = 1, O_FLOAT = 2, O_TEXT = 3 };

struct TextRef {
  size_t off;
  int32_t len;  // -1 = NULL
};

// Heterogeneous (string_view) lookup for the hot per-cell maps: a plain
// std::unordered_map<std::string, …>::find forces a std::string temporary
// per CELL — ~4M heap allocations per 1M-build study across the key and
// intern maps.  Transparent hash/eq let the scan probe with a string_view
// and allocate only on first insertion of a distinct value.  Generic
// unordered lookup needs C++20/libstdc++ >= 11; older toolchains compile
// the std::string-temporary form instead (the Python builder retries with
// -std=c++17) — slower per cell, but the native path stays alive.
#if defined(__cpp_lib_generic_unordered_lookup) && \
    __cpp_lib_generic_unordered_lookup >= 201811L
struct SvHash {
  using is_transparent = void;
  size_t operator()(std::string_view s) const noexcept {
    return std::hash<std::string_view>{}(s);
  }
  size_t operator()(const std::string &s) const noexcept {
    return std::hash<std::string_view>{}(std::string_view(s));
  }
};
using SvMap =
    std::unordered_map<std::string, int32_t, SvHash, std::equal_to<>>;
template <typename M>
inline auto sv_find(M &m, std::string_view k) {
  return m.find(k);
}
#else
using SvMap = std::unordered_map<std::string, int32_t>;
template <typename M>
inline auto sv_find(M &m, std::string_view k) {
  return m.find(std::string(k));
}
#endif

struct Col {
  char spec;                          // p/t/f/s/u/o (+ c/b)
  std::vector<int32_t> i32;           // 'p', and 's'/'c' intern ids
  std::vector<int64_t> i64;           // 't', and 'o' ints
  std::vector<double> f64;            // 'f', and 'o' floats
  std::vector<uint8_t> tag;           // 'o'
  std::vector<TextRef> text;          // 'u'/'b'/'o' arena refs
  std::string arena;                  // 'u'/'b'/'o' raw text bytes
  std::vector<std::string> distinct;  // 's'/'c' intern table
  SvMap intern;                       // 's'/'c'
};

inline PyObject *err(const std::string &msg) {
  PyErr_Format(PyExc_RuntimeError, "native decode: %s", msg.c_str());
  return nullptr;
}

template <typename T>
PyObject *numeric_array(const std::vector<T> &v, int npy_type) {
  npy_intp n = static_cast<npy_intp>(v.size());
  PyObject *arr = PyArray_SimpleNew(1, &n, npy_type);
  if (arr)
    memcpy(PyArray_DATA(reinterpret_cast<PyArrayObject *>(arr)), v.data(),
           v.size() * sizeof(T));
  return arr;
}

// key_values list -> value -> index map (the 'p' column codes).
inline bool build_keymap(PyObject *keys_o, SvMap &keymap) {
  PyObject *fast = PySequence_Fast(keys_o, "key_values");
  if (!fast) return false;
  const Py_ssize_t nk = PySequence_Fast_GET_SIZE(fast);
  for (Py_ssize_t i = 0; i < nk; i++) {
    Py_ssize_t sl;
    const char *sp =
        PyUnicode_AsUTF8AndSize(PySequence_Fast_GET_ITEM(fast, i), &sl);
    if (!sp) {
      Py_DECREF(fast);
      return false;
    }
    keymap.emplace(std::string(sp, sl), static_cast<int32_t>(i));
  }
  Py_DECREF(fast);
  return true;
}

// One column -> numpy array (GIL held), or NULL with an exception set.
inline PyObject *materialize(Col &c) {
  switch (c.spec) {
    case 'p':
      return numeric_array(c.i32, NPY_INT32);
    case 't':
      return numeric_array(c.i64, NPY_INT64);
    case 'f':
      return numeric_array(c.f64, NPY_FLOAT64);
    default:
      break;
  }
  if (c.spec == 'b') {
    // Lazy bytes column: (uint8 arena, int64 starts, int32 lens) — zero
    // per-row Python objects; the Python BytesColumn wrapper decodes
    // single cells on demand (consumers touch only tiny subsets of these
    // near-unique columns).  len -1 = NULL.
    std::vector<int64_t> starts(c.text.size());
    std::vector<int32_t> lens(c.text.size());
    for (size_t i = 0; i < c.text.size(); i++) {
      starts[i] = static_cast<int64_t>(c.text[i].off);
      lens[i] = c.text[i].len;
    }
    npy_intp asize = static_cast<npy_intp>(c.arena.size());
    PyObject *arena = PyArray_SimpleNew(1, &asize, NPY_UINT8);
    if (!arena) return nullptr;
    memcpy(PyArray_DATA(reinterpret_cast<PyArrayObject *>(arena)),
           c.arena.data(), c.arena.size());
    PyObject *st = numeric_array(starts, NPY_INT64);
    PyObject *ln = numeric_array(lens, NPY_INT32);
    if (!st || !ln) {
      Py_DECREF(arena);
      Py_XDECREF(st);
      Py_XDECREF(ln);
      return nullptr;
    }
    PyObject *triple = PyTuple_Pack(3, arena, st, ln);
    Py_DECREF(arena);
    Py_DECREF(st);
    Py_DECREF(ln);
    return triple;
  }
  if (c.spec == 'c') {
    // Coded column: (int32 codes, vocab list) — ZERO per-row Python
    // objects.  -1 = NULL; vocab order is first appearance (matches
    // CodedColumn.factorize in the fallback, so codes are identical).
    PyObject *codes = numeric_array(c.i32, NPY_INT32);
    if (!codes) return nullptr;
    PyObject *vocab = PyList_New(static_cast<Py_ssize_t>(c.distinct.size()));
    if (!vocab) {
      Py_DECREF(codes);
      return nullptr;
    }
    for (size_t i = 0; i < c.distinct.size(); i++) {
      PyObject *o = PyUnicode_DecodeUTF8(
          c.distinct[i].data(),
          static_cast<Py_ssize_t>(c.distinct[i].size()), nullptr);
      if (!o) {
        Py_DECREF(codes);
        Py_DECREF(vocab);
        return nullptr;
      }
      PyList_SET_ITEM(vocab, static_cast<Py_ssize_t>(i), o);
    }
    PyObject *pair = PyTuple_Pack(2, codes, vocab);
    Py_DECREF(codes);
    Py_DECREF(vocab);
    return pair;
  }
  const size_t n_rows = c.spec == 's' ? c.i32.size() : c.text.size();
  npy_intp n = static_cast<npy_intp>(n_rows);
  PyObject *arr = PyArray_SimpleNew(1, &n, NPY_OBJECT);
  if (!arr) return nullptr;
  PyObject **data = reinterpret_cast<PyObject **>(
      PyArray_DATA(reinterpret_cast<PyArrayObject *>(arr)));
  if (c.spec == 's') {
    std::vector<PyObject *> uniq(c.distinct.size());
    for (size_t i = 0; i < c.distinct.size(); i++) {
      uniq[i] = PyUnicode_DecodeUTF8(c.distinct[i].data(),
                                     static_cast<Py_ssize_t>(
                                         c.distinct[i].size()), nullptr);
      if (!uniq[i]) {
        for (size_t j = 0; j < i; j++) Py_DECREF(uniq[j]);
        Py_DECREF(arr);
        return nullptr;
      }
    }
    for (size_t r = 0; r < n_rows; r++) {
      PyObject *o = c.i32[r] < 0 ? Py_None : uniq[c.i32[r]];
      Py_INCREF(o);
      data[r] = o;
    }
    for (auto *o : uniq) Py_DECREF(o);  // array rows now hold the refs
    return arr;
  }
  for (size_t r = 0; r < n_rows; r++) {
    const TextRef &t = c.text[r];
    PyObject *o;
    if (c.spec == 'o' && c.tag[r] == O_INT)
      o = PyLong_FromLongLong(c.i64[r]);
    else if (c.spec == 'o' && c.tag[r] == O_FLOAT)
      o = PyFloat_FromDouble(c.f64[r]);
    else if (t.len < 0) {
      o = Py_None;
      Py_INCREF(o);
    } else {
      o = PyUnicode_DecodeUTF8(c.arena.data() + t.off, t.len, nullptr);
    }
    if (!o) {
      Py_DECREF(arr);  // frees the rows materialized so far
      return nullptr;
    }
    data[r] = o;
  }
  return arr;
}

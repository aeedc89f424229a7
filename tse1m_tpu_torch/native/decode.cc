// Native bulk decoder: sqlite rows -> typed numpy columns in one C++ pass,
// a copy of the JAX package's decode.cc.
//
// Two phases:
//   1. GIL-RELEASED scan: the sqlite3_step loop entirely in C++ (project
//      key lookups, strict ISO8601 -> epoch-ns parsing, numerics into
//      typed vectors, text into an arena, interned text into a per-column
//      distinct-string table).
//   2. GIL-HELD materialisation: numpy buffers via memcpy; one PyUnicode
//      per distinct interned value; arena text -> PyUnicode for the 's',
//      'u' and 'o' columns.
//
// Parity contract: anything the strict parsers cannot prove they decode
// as the numpy path does (timezone suffixes, text in numeric columns,
// unknown keys) raises RuntimeError, and the caller falls back to numpy
// for that table (tests/test_torch_native.py).
//
// The sqlite3 prototypes are declared inline because a machine may ship
// libsqlite3.so.0 without its header; they are the documented,
// ABI-stable public C API (sqlite.org/c3ref).

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <variant>
#include <vector>

extern "C" {
typedef struct sqlite3 sqlite3;
typedef struct sqlite3_stmt sqlite3_stmt;
int sqlite3_open_v2(const char *, sqlite3 **, int, const char *);
int sqlite3_prepare_v2(sqlite3 *, const char *, int, sqlite3_stmt **,
                       const char **);
int sqlite3_bind_text(sqlite3_stmt *, int, const char *, int, void (*)(void *));
int sqlite3_bind_int64(sqlite3_stmt *, int, long long);
int sqlite3_bind_double(sqlite3_stmt *, int, double);
int sqlite3_step(sqlite3_stmt *);
int sqlite3_column_count(sqlite3_stmt *);
int sqlite3_column_type(sqlite3_stmt *, int);
const unsigned char *sqlite3_column_text(sqlite3_stmt *, int);
int sqlite3_column_bytes(sqlite3_stmt *, int);
long long sqlite3_column_int64(sqlite3_stmt *, int);
double sqlite3_column_double(sqlite3_stmt *, int);
int sqlite3_finalize(sqlite3_stmt *);
int sqlite3_close(sqlite3 *);
const char *sqlite3_errmsg(sqlite3 *);
}

#define SQLITE_OK 0
#define SQLITE_ROW 100
#define SQLITE_DONE 101
#define SQLITE_OPEN_READONLY 0x01
#define SQLITE_INTEGER 1
#define SQLITE_FLOAT 2
#define SQLITE_TEXT 3
#define SQLITE_NULL 5
#define SQLITE_TRANSIENT ((void (*)(void *))(intptr_t)-1)

namespace {

// ---- ISO8601 -> epoch ns ---------------------------------------------------

inline bool all_digits(const char *s, int n) {
  for (int i = 0; i < n; i++)
    if (s[i] < '0' || s[i] > '9') return false;
  return true;
}

inline long long to_int(const char *s, int n) {
  long long v = 0;
  for (int i = 0; i < n; i++) v = v * 10 + (s[i] - '0');
  return v;
}

// Howard Hinnant's days_from_civil (public-domain algorithm).
inline int64_t days_from_civil(int y, unsigned m, unsigned d) {
  y -= m <= 2;
  const int era = (y >= 0 ? y : y - 399) / 400;
  const unsigned yoe = static_cast<unsigned>(y - era * 400);
  const unsigned doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
  const unsigned doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return static_cast<int64_t>(era) * 146097 + static_cast<int64_t>(doe) -
         719468;
}

// Strict parse of "YYYY-MM-DD", "YYYY-MM-DD[ T]HH:MM[:SS[.frac]]".
// Returns false on anything else (timezone suffixes included): the caller
// then falls back to the numpy parser rather than guessing.
bool parse_iso_ns(const char *s, int len, int64_t *out) {
  if (len < 10) return false;
  if (!all_digits(s, 4) || s[4] != '-' || !all_digits(s + 5, 2) ||
      s[7] != '-' || !all_digits(s + 8, 2))
    return false;
  const int y = static_cast<int>(to_int(s, 4));
  const unsigned mo = static_cast<unsigned>(to_int(s + 5, 2));
  const unsigned d = static_cast<unsigned>(to_int(s + 8, 2));
  if (mo < 1 || mo > 12 || d < 1) return false;
  // Real month lengths (leap-aware): days_from_civil would silently
  // normalize e.g. Feb 30 -> Mar 1, where numpy raises, and a raise is
  // what routes the fetch to the fallback.
  static const unsigned mdays[] = {31, 28, 31, 30, 31, 30,
                                   31, 31, 30, 31, 30, 31};
  const bool leap = (y % 4 == 0 && y % 100 != 0) || y % 400 == 0;
  if (d > (mo == 2 && leap ? 29u : mdays[mo - 1])) return false;
  int64_t secs = days_from_civil(y, mo, d) * 86400;
  int64_t frac_ns = 0;
  if (len > 10) {
    if ((s[10] != ' ' && s[10] != 'T') || len < 16) return false;
    if (!all_digits(s + 11, 2) || s[13] != ':' || !all_digits(s + 14, 2))
      return false;
    const long long hh = to_int(s + 11, 2), mi = to_int(s + 14, 2);
    if (hh > 23 || mi > 59) return false;
    secs += hh * 3600 + mi * 60;
    int pos = 16;
    if (len > 16) {
      if (s[16] != ':' || len < 19 || !all_digits(s + 17, 2)) return false;
      const long long ss = to_int(s + 17, 2);
      if (ss > 59) return false;
      secs += ss;
      pos = 19;
      if (len > 19) {
        if (s[19] != '.') return false;
        int nd = len - 20;
        if (nd < 1 || nd > 9 || !all_digits(s + 20, nd)) return false;
        long long f = to_int(s + 20, nd);
        for (int i = nd; i < 9; i++) f *= 10;
        frac_ns = f;
        pos = len;
      }
    }
    if (pos != len) return false;
  }
  *out = secs * 1000000000LL + frac_ns;
  return true;
}

// ---- GIL-free column accumulators (shared with pg_decode.cc) ---------------

#include "columns.h"

using Param = std::variant<std::string, long long, double>;

// Phase 1: everything between open and finalize runs WITHOUT the GIL.
// Returns empty string on success, else an error message.
std::string scan(const std::string &db_path, const std::string &sql,
                 const std::vector<Param> &params,
                 const SvMap &keymap,
                 std::vector<Col> &cols) {
  sqlite3 *db = nullptr;
  sqlite3_stmt *stmt = nullptr;
  auto fail = [&](const std::string &msg) {
    std::string full = msg;
    if (db) {
      full += ": ";
      full += sqlite3_errmsg(db);
    }
    if (stmt) sqlite3_finalize(stmt);
    if (db) sqlite3_close(db);
    return full;
  };
  if (sqlite3_open_v2(db_path.c_str(), &db, SQLITE_OPEN_READONLY, nullptr) !=
      SQLITE_OK)
    return fail("cannot open database");
  if (sqlite3_prepare_v2(db, sql.c_str(), -1, &stmt, nullptr) != SQLITE_OK)
    return fail("prepare failed");
  for (size_t i = 0; i < params.size(); i++) {
    int rc;
    const int pi = static_cast<int>(i + 1);
    if (auto *s = std::get_if<std::string>(&params[i]))
      rc = sqlite3_bind_text(stmt, pi, s->c_str(),
                             static_cast<int>(s->size()), SQLITE_TRANSIENT);
    else if (auto *v = std::get_if<long long>(&params[i]))
      rc = sqlite3_bind_int64(stmt, pi, *v);
    else
      rc = sqlite3_bind_double(stmt, pi, std::get<double>(params[i]));
    if (rc != SQLITE_OK) return fail("bind failed");
  }
  const int ncol = static_cast<int>(cols.size());
  if (sqlite3_column_count(stmt) != ncol)
    return fail("spec length != selected column count");

  int rc;
  while ((rc = sqlite3_step(stmt)) == SQLITE_ROW) {
    for (int ci = 0; ci < ncol; ci++) {
      Col &c = cols[ci];
      const int ty = sqlite3_column_type(stmt, ci);
      switch (c.spec) {
        case 'p': {
          if (ty != SQLITE_TEXT) return fail("key column must be TEXT");
          const char *sp = reinterpret_cast<const char *>(
              sqlite3_column_text(stmt, ci));
          auto it = sv_find(keymap, std::string_view(
              sp, static_cast<size_t>(sqlite3_column_bytes(stmt, ci))));
          if (it == keymap.end()) return fail("key value not in key_values");
          c.i32.push_back(it->second);
          break;
        }
        case 't': {
          if (ty != SQLITE_TEXT)
            return fail("timestamp column must be TEXT "
                        "(caller should fall back)");
          int64_t ns;
          if (!parse_iso_ns(reinterpret_cast<const char *>(
                                sqlite3_column_text(stmt, ci)),
                            sqlite3_column_bytes(stmt, ci), &ns))
            return fail("unparseable timestamp (caller should fall back)");
          c.i64.push_back(ns);
          break;
        }
        case 'f': {
          // TEXT is rejected rather than coerced: sqlite3_column_double
          // turns junk text into 0.0 silently; the fetch falls back
          // instead.
          if (ty == SQLITE_NULL)
            c.f64.push_back(Py_NAN);
          else if (ty == SQLITE_INTEGER || ty == SQLITE_FLOAT)
            c.f64.push_back(sqlite3_column_double(stmt, ci));
          else
            return fail("non-numeric cell in float column "
                        "(caller should fall back)");
          break;
        }
        case 's':
        case 'c': {  // same interned scan; they differ at materialize
          if (ty == SQLITE_NULL) {
            c.i32.push_back(-1);
            break;
          }
          const char *sp = reinterpret_cast<const char *>(
              sqlite3_column_text(stmt, ci));
          const std::string_view key(
              sp, static_cast<size_t>(sqlite3_column_bytes(stmt, ci)));
          auto it = sv_find(c.intern, key);
          if (it == c.intern.end()) {
            it = c.intern
                     .emplace(std::string(key),
                              static_cast<int32_t>(c.distinct.size()))
                     .first;
            c.distinct.push_back(it->first);
          }
          c.i32.push_back(it->second);
          break;
        }
        case 'u':
        case 'b': {  // same arena scan; 'b' materialises lazily
          if (ty == SQLITE_NULL) {
            c.text.push_back({0, -1});
            break;
          }
          const char *sp = reinterpret_cast<const char *>(
              sqlite3_column_text(stmt, ci));
          const int sl = sqlite3_column_bytes(stmt, ci);
          c.text.push_back({c.arena.size(), sl});
          c.arena.append(sp, sl);
          break;
        }
        case 'o': {
          if (ty == SQLITE_NULL) {
            c.tag.push_back(O_NULL);
            c.i64.push_back(0);
            c.f64.push_back(0.0);
            c.text.push_back({0, -1});
          } else if (ty == SQLITE_INTEGER) {
            c.tag.push_back(O_INT);
            c.i64.push_back(sqlite3_column_int64(stmt, ci));
            c.f64.push_back(0.0);
            c.text.push_back({0, -1});
          } else if (ty == SQLITE_FLOAT) {
            c.tag.push_back(O_FLOAT);
            c.i64.push_back(0);
            c.f64.push_back(sqlite3_column_double(stmt, ci));
            c.text.push_back({0, -1});
          } else {
            const char *sp = reinterpret_cast<const char *>(
                sqlite3_column_text(stmt, ci));
            const int sl = sqlite3_column_bytes(stmt, ci);
            c.tag.push_back(O_TEXT);
            c.i64.push_back(0);
            c.f64.push_back(0.0);
            c.text.push_back({c.arena.size(), sl});
            c.arena.append(sp, sl);
          }
          break;
        }
      }
    }
  }
  if (rc != SQLITE_DONE) return fail("step failed");
  sqlite3_finalize(stmt);
  sqlite3_close(db);
  return "";
}

// err/numeric_array/materialize live in columns.h (shared with the
// Postgres COPY-binary decoder).

// fetch_table(db_path, sql, params, spec, key_values) -> tuple of arrays
//
// spec: one char per selected column —
//   p  TEXT key -> int32 code via the key_values list (error if unseen)
//   t  TEXT ISO8601 -> int64 epoch-ns
//   f  numeric -> float64 (NULL -> NaN; TEXT rejected)
//   s  TEXT -> object array, values interned per column
//   c  TEXT -> (int32 codes, vocab list) — interned like 's' but with NO
//      per-row Python objects (codes in first-appearance order, as
//      CodedColumn.factorize; -1 = NULL)
//   u  TEXT -> object array, no interning (high-cardinality, e.g. names)
//   b  TEXT -> (uint8 arena, int64 starts, int32 lens) — like 'u' but with
//      NO per-row Python objects; cells decode lazily on the Python side
//      (len -1 = NULL)
//   o  object array preserving sqlite's native type (int/float/text/None)
PyObject *fetch_table(PyObject *, PyObject *args) {
  const char *db_path_c, *sql_c, *spec_c;
  PyObject *params_o, *keys_o;
  if (!PyArg_ParseTuple(args, "ssOsO", &db_path_c, &sql_c, &params_o, &spec_c,
                        &keys_o))
    return nullptr;
  if (!PySequence_Check(params_o) || !PySequence_Check(keys_o))
    return err("params and key_values must be sequences");

  const std::string db_path(db_path_c), sql(sql_c), spec(spec_c);
  std::vector<Col> cols(spec.size());
  for (size_t i = 0; i < spec.size(); i++) {
    cols[i].spec = spec[i];
    if (!strchr("ptfscubo", spec[i])) return err("unknown spec char");
  }

  // Extract params / keys into pure C++ while still holding the GIL.
  std::vector<Param> params;
  {
    PyObject *fast = PySequence_Fast(params_o, "params");
    if (!fast) return nullptr;
    const Py_ssize_t np = PySequence_Fast_GET_SIZE(fast);
    for (Py_ssize_t i = 0; i < np; i++) {
      PyObject *p = PySequence_Fast_GET_ITEM(fast, i);
      if (PyUnicode_Check(p)) {
        Py_ssize_t sl;
        const char *sp = PyUnicode_AsUTF8AndSize(p, &sl);
        if (!sp) {
          Py_DECREF(fast);
          return nullptr;
        }
        params.emplace_back(std::string(sp, sl));
      } else if (PyLong_Check(p)) {
        params.emplace_back(static_cast<long long>(PyLong_AsLongLong(p)));
        if (PyErr_Occurred()) {
          Py_DECREF(fast);
          return nullptr;
        }
      } else if (PyFloat_Check(p)) {
        params.emplace_back(PyFloat_AsDouble(p));
      } else {
        Py_DECREF(fast);
        return err("unsupported parameter type");
      }
    }
    Py_DECREF(fast);
  }
  SvMap keymap;
  if (!build_keymap(keys_o, keymap)) return nullptr;

  // Phase 1: the whole sqlite scan runs without the GIL.
  std::string scan_err;
  Py_BEGIN_ALLOW_THREADS;
  scan_err = scan(db_path, sql, params, keymap, cols);
  Py_END_ALLOW_THREADS;
  if (!scan_err.empty()) return err(scan_err);

  // Phase 2: materialize numpy arrays under the GIL.
  PyObject *out = PyTuple_New(static_cast<Py_ssize_t>(cols.size()));
  if (!out) return nullptr;
  for (size_t i = 0; i < cols.size(); i++) {
    PyObject *arr = materialize(cols[i]);
    if (!arr) {
      Py_DECREF(out);
      return nullptr;
    }
    PyTuple_SET_ITEM(out, static_cast<Py_ssize_t>(i), arr);
  }
  return out;
}

PyMethodDef methods[] = {
    {"fetch_table", fetch_table, METH_VARARGS,
     "fetch_table(db_path, sql, params, spec, key_values) -> tuple of numpy "
     "arrays"},
    {nullptr, nullptr, 0, nullptr}};

struct PyModuleDef moddef = {PyModuleDef_HEAD_INIT, "_tse1m_torch_decode",
                             "sqlite -> numpy bulk decoder", -1, methods,
                             nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit__tse1m_torch_decode(void) {
  import_array();
  return PyModule_Create(&moddef);
}

// CPython-API pass for the engine's inner-join bilinear update — the
// port's copy of the JAX package's native/fastjoin.cpp, under a module name
// of its own (torch_fastjoin), so that a process holding both packages
// never gets one package's module back for the other's.
//
// The Python implementation (pathway_tpu_torch/engine/operators.py
// JoinOperator._one_side_inner) pays interpreter dispatch per entry: dict
// probes into the two join-state indexes, output-key cache probes, tuple
// builds for every emitted row. This module runs the identical algorithm
// at C speed. Semantics are the Python path's exactly: fused
// retract+insert upsert pairs, exact multiset emissions, state applied
// entry by entry.
//
// ABI: a CPython extension (PyInit_torch_fastjoin), built on first use by
// pathway_tpu_torch/native/build.py:load_extension. The operator runs its
// Python loops when the build fails.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

namespace {

// out_spec item tags (see runner._direct_join_projection's C spec)
//   (0, pos) -> lrow[pos]; (1, pos) -> rrow[pos]; (2, 0) -> lk; (2, 1) -> rk
struct SpecItem {
  int side;  // 0 = left row, 1 = right row, 2 = key
  Py_ssize_t pos;
};

// ---- native 128-bit pointer mix -------------------------------------------
// Identical algorithm to internals/keys.py mix_pointers: multiply-xor over
// u128, Python-int I/O via little-endian byte arrays.
typedef unsigned __int128 u128;

static const u128 MIX_A = ((u128)0x9E3779B97F4A7C15ULL << 64) |
                          0xF39CC0605CEDC835ULL;
static const u128 MIX_B = ((u128)0xC2B2AE3D27D4EB4FULL << 64) |
                          0x165667B19E3779F9ULL;

static int py_to_u128(PyObject *v, u128 *out) {
  unsigned char buf[16];
#if PY_VERSION_HEX >= 0x030D0000  // 3.13 added with_exceptions
  if (_PyLong_AsByteArray((PyLongObject *)v, buf, 16, /*little*/ 1,
                          /*signed*/ 0, /*with_exceptions*/ 1) < 0) {
#else
  if (_PyLong_AsByteArray((PyLongObject *)v, buf, 16, /*little*/ 1,
                          /*signed*/ 0) < 0) {
#endif
    PyErr_Clear();
    return -1;
  }
  u128 x = 0;
  for (int i = 15; i >= 0; i--) x = (x << 8) | buf[i];
  *out = x;
  return 0;
}

static PyObject *u128_to_py(u128 x, PyObject *pointer_type) {
  unsigned char buf[16];
  for (int i = 0; i < 16; i++) {
    buf[i] = (unsigned char)(x & 0xff);
    x >>= 8;
  }
  PyObject *n = _PyLong_FromByteArray(buf, 16, /*little*/ 1, /*signed*/ 0);
  if (!n || !pointer_type) return n;
  PyObject *p = PyObject_CallFunctionObjArgs(pointer_type, n, NULL);
  Py_DECREF(n);
  return p;
}

static PyObject *native_mix(PyObject *lk, PyObject *rk,
                            PyObject *pointer_type) {
  u128 x, y;
  if (!PyLong_Check(lk) || !PyLong_Check(rk) || py_to_u128(lk, &x) < 0 ||
      py_to_u128(rk, &y) < 0)
    return nullptr;  // caller falls back to the Python mix
  x *= MIX_A;
  y *= MIX_B;
  u128 z = x ^ (y >> 63) ^ (y << 65);
  z *= MIX_A;
  return u128_to_py(z ^ (z >> 64), pointer_type);
}

struct Ctx {
  PyObject *my_index;      // dict: jk -> {key: row}
  PyObject *other_index;   // dict: jk -> {key: row}
  PyObject *mix_cache;     // dict: (lk, rk) -> out key
  PyObject *mix_fn;        // python fallback callable(lk, rk) -> out key
  PyObject *pointer_type;  // internals.keys.Pointer
  PyObject *out_fn;        // callable or NULL when spec is used
  SpecItem *spec;          // projection spec or NULL
  Py_ssize_t spec_len;
  int flip;                // entries are the RIGHT side when true
  PyObject *out;           // result list of (okey, row, diff)
};

// okey = mix cache probe, miss -> native u128 mix (python mix fallback)
static PyObject *out_key(Ctx &c, PyObject *lk, PyObject *rk) {
  PyObject *ck = PyTuple_Pack(2, lk, rk);
  if (!ck) return nullptr;
  PyObject *hit = PyDict_GetItemWithError(c.mix_cache, ck);
  if (hit) {
    Py_INCREF(hit);
    Py_DECREF(ck);
    return hit;
  }
  if (PyErr_Occurred()) {
    Py_DECREF(ck);
    return nullptr;
  }
  PyObject *key = native_mix(lk, rk, c.pointer_type);
  if (!key && !PyErr_Occurred())
    key = PyObject_CallFunctionObjArgs(c.mix_fn, lk, rk, NULL);
  if (key && PyDict_Size(c.mix_cache) < (1 << 20))
    PyDict_SetItem(c.mix_cache, ck, key);
  Py_DECREF(ck);
  return key;
}

// build one output row: spec projection (fast) or out_fn callback
static PyObject *out_row(Ctx &c, PyObject *lk, PyObject *lrow, PyObject *rk,
                         PyObject *rrow) {
  if (!c.spec)
    return PyObject_CallFunctionObjArgs(c.out_fn, lk, lrow, rk, rrow, NULL);
  PyObject *t = PyTuple_New(c.spec_len);
  if (!t) return nullptr;
  for (Py_ssize_t i = 0; i < c.spec_len; i++) {
    const SpecItem &it = c.spec[i];
    PyObject *v;
    if (it.side == 0)
      v = PyTuple_GET_ITEM(lrow, it.pos);
    else if (it.side == 1)
      v = PyTuple_GET_ITEM(rrow, it.pos);
    else
      v = (it.pos == 0) ? lk : rk;
    Py_INCREF(v);
    PyTuple_SET_ITEM(t, i, v);
  }
  return t;
}

static int emit(Ctx &c, PyObject *okey, PyObject *row, long diff) {
  PyObject *d = PyLong_FromLong(diff);
  if (!d) return -1;
  PyObject *e = PyTuple_Pack(3, okey, row, d);
  Py_DECREF(d);
  if (!e) return -1;
  int rc = PyList_Append(c.out, e);
  Py_DECREF(e);
  return rc;
}

// emit +/-1 outputs of one my-side row against every other-side match
static int emit_matches(Ctx &c, PyObject *og, PyObject *k, PyObject *row,
                        long sign) {
  PyObject *ok_, *orow;
  Py_ssize_t pos = 0;
  while (PyDict_Next(og, &pos, &ok_, &orow)) {
    PyObject *lk = c.flip ? ok_ : k;
    PyObject *rk = c.flip ? k : ok_;
    PyObject *lrow = c.flip ? orow : row;
    PyObject *rrow = c.flip ? row : orow;
    PyObject *okey = out_key(c, lk, rk);
    if (!okey) return -1;
    PyObject *orow2 = out_row(c, lk, lrow, rk, rrow);
    if (!orow2) {
      Py_DECREF(okey);
      return -1;
    }
    int rc = emit(c, okey, orow2, sign);
    Py_DECREF(okey);
    Py_DECREF(orow2);
    if (rc < 0) return -1;
  }
  return 0;
}

// upsert emission: per match, one okey and a retract+insert pair
static int emit_upserts(Ctx &c, PyObject *og, PyObject *k, PyObject *oldrow,
                        PyObject *newrow) {
  PyObject *ok_, *orow;
  Py_ssize_t pos = 0;
  while (PyDict_Next(og, &pos, &ok_, &orow)) {
    PyObject *lk = c.flip ? ok_ : k;
    PyObject *rk = c.flip ? k : ok_;
    PyObject *okey = out_key(c, lk, rk);
    if (!okey) return -1;
    PyObject *r1 = c.flip ? out_row(c, lk, orow, rk, oldrow)
                          : out_row(c, lk, oldrow, rk, orow);
    if (!r1 || emit(c, okey, r1, -1) < 0) {
      Py_XDECREF(r1);
      Py_DECREF(okey);
      return -1;
    }
    Py_DECREF(r1);
    PyObject *r2 = c.flip ? out_row(c, lk, orow, rk, newrow)
                          : out_row(c, lk, newrow, rk, orow);
    if (!r2 || emit(c, okey, r2, 1) < 0) {
      Py_XDECREF(r2);
      Py_DECREF(okey);
      return -1;
    }
    Py_DECREF(r2);
    Py_DECREF(okey);
  }
  return 0;
}

// rows equal? rich compare; on comparison error (ndarray cells) treat as
// NOT equal — a retract+insert of an identical row is multiset-correct
static int rows_equal(PyObject *a, PyObject *b) {
  int r = PyObject_RichCompareBool(a, b, Py_EQ);
  if (r < 0) {
    PyErr_Clear();
    return 0;
  }
  return r;
}

// state mutation mirroring JoinOperator._apply
static int apply_insert(Ctx &c, PyObject *jk, PyObject *k, PyObject *row) {
  PyObject *grp = PyDict_GetItemWithError(c.my_index, jk);
  if (!grp) {
    if (PyErr_Occurred()) return -1;
    grp = PyDict_New();
    if (!grp) return -1;
    int rc = PyDict_SetItem(c.my_index, jk, grp);
    Py_DECREF(grp);
    if (rc < 0) return -1;
  }
  return PyDict_SetItem(grp, k, row);
}

static int apply_remove(Ctx &c, PyObject *jk, PyObject *grp, PyObject *k) {
  if (PyDict_DelItem(grp, k) < 0) PyErr_Clear();
  if (PyDict_Size(grp) == 0)
    if (PyDict_DelItem(c.my_index, jk) < 0) PyErr_Clear();
  return 0;
}

// join key from a raw entry's row: EXACT str / int / Pointer pass through
// raw — exact types only, matching runner._jkey's `cls is` checks (str/int
// subclasses like np.str_ or IntEnum must hash, or native and fallback
// paths would key the same data differently). Everything else — None,
// bool, float, np scalars — goes through the python fallback, which
// reproduces _jkey exactly. Returns a NEW reference.
static PyObject *extract_key(PyObject *row, PyObject *k, Py_ssize_t key_pos,
                             PyObject *key_fb, PyObject *pointer_type) {
  PyObject *v = PyTuple_GET_ITEM(row, key_pos);
  PyTypeObject *t = Py_TYPE(v);
  if (t == &PyUnicode_Type || t == &PyLong_Type ||
      (PyObject *)t == pointer_type) {
    Py_INCREF(v);
    return v;
  }
  return PyObject_CallFunctionObjArgs(key_fb, v, k, NULL);
}

// one entry (jk owned by caller); may consume the following entry via *ip
// when it fuses an upsert pair. Returns 0 ok / -1 error.
static int process_entry(Ctx &c, PyObject *entries, Py_ssize_t *ip,
                         Py_ssize_t n, Py_ssize_t key_pos, PyObject *key_fb,
                         PyObject *jk, PyObject *k, PyObject *row, long d) {
  PyObject *grp = PyDict_GetItemWithError(c.my_index, jk);
  if (!grp && PyErr_Occurred()) return -1;
  PyObject *cur = grp ? PyDict_GetItemWithError(grp, k) : nullptr;
  if (!cur && PyErr_Occurred()) return -1;

  if (d > 0) {
    if (cur) {
      Py_INCREF(cur);
      if (rows_equal(cur, row)) {
        Py_DECREF(cur);
        return 0;  // duplicate upsert: outputs unchanged
      }
      PyObject *og = PyDict_GetItemWithError(c.other_index, jk);
      if ((!og && PyErr_Occurred()) ||
          (og && emit_upserts(c, og, k, cur, row) < 0)) {
        Py_DECREF(cur);
        return -1;
      }
      Py_DECREF(cur);
      return PyDict_SetItem(grp, k, row);
    }
    PyObject *og = PyDict_GetItemWithError(c.other_index, jk);
    if (!og && PyErr_Occurred()) return -1;
    if (og && emit_matches(c, og, k, row, 1) < 0) return -1;
    return apply_insert(c, jk, k, row);
  }

  if (!cur) return 0;  // retraction of an absent row: no-op
  Py_INCREF(cur);
  // fuse an adjacent insert of the same (jk, key): one upsert
  PyObject *nxt = nullptr;
  if (*ip < n) {
    PyObject *e2 = PyList_GET_ITEM(entries, *ip);
    PyObject *k2, *row2, *d2o;
    if (key_pos < 0) {
      k2 = PyTuple_GET_ITEM(e2, 1);
      row2 = PyTuple_GET_ITEM(e2, 2);
      d2o = PyTuple_GET_ITEM(e2, 3);
    } else {
      k2 = PyTuple_GET_ITEM(e2, 0);
      row2 = PyTuple_GET_ITEM(e2, 1);
      d2o = PyTuple_GET_ITEM(e2, 2);
    }
    long d2 = PyLong_AsLong(d2o);
    if (d2 == -1 && PyErr_Occurred()) {
      Py_DECREF(cur);
      return -1;
    }
    if (d2 > 0) {
      int keq = PyObject_RichCompareBool(k2, k, Py_EQ);
      if (keq < 0) {
        Py_DECREF(cur);
        return -1;
      }
      if (keq) {
        PyObject *jk2 =
            key_pos < 0
                ? Py_NewRef(PyTuple_GET_ITEM(e2, 0))
                : extract_key(row2, k2, key_pos, key_fb, c.pointer_type);
        if (!jk2) {
          Py_DECREF(cur);
          return -1;
        }
        int jeq = PyObject_RichCompareBool(jk2, jk, Py_EQ);
        Py_DECREF(jk2);
        if (jeq < 0) {
          Py_DECREF(cur);
          return -1;
        }
        if (jeq) {
          nxt = row2;
          (*ip)++;
        }
      }
    }
  }
  if (nxt) {
    if (rows_equal(cur, nxt)) {
      Py_DECREF(cur);
      return 0;  // value unchanged: no outputs, no state change
    }
    PyObject *og = PyDict_GetItemWithError(c.other_index, jk);
    if ((!og && PyErr_Occurred()) ||
        (og && emit_upserts(c, og, k, cur, nxt) < 0)) {
      Py_DECREF(cur);
      return -1;
    }
    Py_DECREF(cur);
    return PyDict_SetItem(grp, k, nxt);
  }
  PyObject *og = PyDict_GetItemWithError(c.other_index, jk);
  if ((!og && PyErr_Occurred()) ||
      (og && emit_matches(c, og, k, cur, -1) < 0)) {
    Py_DECREF(cur);
    return -1;
  }
  Py_DECREF(cur);
  apply_remove(c, jk, grp, k);
  return 0;
}

static PyObject *one_side_inner(PyObject * /*self*/, PyObject *args) {
  PyObject *entries, *my_index, *other_index, *mix_cache, *mix_fn,
      *pointer_type, *out_fn, *spec_obj, *key_fb;
  int flip;
  Py_ssize_t key_pos;
  if (!PyArg_ParseTuple(args, "O!O!O!O!OOOOpnO", &PyList_Type, &entries,
                        &PyDict_Type, &my_index, &PyDict_Type, &other_index,
                        &PyDict_Type, &mix_cache, &mix_fn, &pointer_type,
                        &out_fn, &spec_obj, &flip, &key_pos, &key_fb))
    return nullptr;

  Ctx c;
  c.my_index = my_index;
  c.other_index = other_index;
  c.mix_cache = mix_cache;
  c.mix_fn = mix_fn;
  c.pointer_type = pointer_type;
  c.out_fn = (out_fn == Py_None) ? nullptr : out_fn;
  c.spec = nullptr;
  c.spec_len = 0;
  c.flip = flip;
  c.out = PyList_New(0);
  if (!c.out) return nullptr;

  SpecItem *spec_buf = nullptr;
  if (spec_obj != Py_None) {
    c.spec_len = PySequence_Size(spec_obj);
    spec_buf = (SpecItem *)PyMem_Malloc(sizeof(SpecItem) *
                                        (c.spec_len ? c.spec_len : 1));
    if (!spec_buf) {
      Py_DECREF(c.out);
      return PyErr_NoMemory();
    }
    for (Py_ssize_t i = 0; i < c.spec_len; i++) {
      PyObject *it = PySequence_GetItem(spec_obj, i);
      spec_buf[i].side = (int)PyLong_AsLong(PyTuple_GET_ITEM(it, 0));
      spec_buf[i].pos = PyLong_AsSsize_t(PyTuple_GET_ITEM(it, 1));
      Py_DECREF(it);
    }
    c.spec = spec_buf;
  } else if (!c.out_fn) {
    Py_DECREF(c.out);
    PyErr_SetString(PyExc_TypeError, "need out_fn or spec");
    return nullptr;
  }

  Py_ssize_t n = PyList_GET_SIZE(entries);
  Py_ssize_t i = 0;
  int rc = 0;
  while (i < n) {
    PyObject *e = PyList_GET_ITEM(entries, i);
    i++;
    PyObject *jk, *k, *row;
    long d;
    if (key_pos < 0) {  // pre-keyed 4-tuples (jk, k, row, d)
      jk = PyTuple_GET_ITEM(e, 0);
      k = PyTuple_GET_ITEM(e, 1);
      row = PyTuple_GET_ITEM(e, 2);
      d = PyLong_AsLong(PyTuple_GET_ITEM(e, 3));
      if (d == -1 && PyErr_Occurred()) {
        rc = -1;
        break;
      }
      if (jk == Py_None) continue;
      Py_INCREF(jk);
    } else {  // raw delta entries (k, row, d); jk extracted inline
      k = PyTuple_GET_ITEM(e, 0);
      row = PyTuple_GET_ITEM(e, 1);
      d = PyLong_AsLong(PyTuple_GET_ITEM(e, 2));
      if (d == -1 && PyErr_Occurred()) {
        rc = -1;
        break;
      }
      jk = extract_key(row, k, key_pos, key_fb, pointer_type);
      if (!jk) {
        rc = -1;
        break;
      }
    }
    rc = process_entry(c, entries, &i, n, key_pos, key_fb, jk, k, row, d);
    Py_DECREF(jk);
    if (rc < 0) break;
  }
  PyMem_Free(spec_buf);
  if (rc < 0) {
    Py_DECREF(c.out);
    return nullptr;
  }
  return c.out;
}

static PyMethodDef Methods[] = {
    {"one_side_inner", one_side_inner, METH_VARARGS,
     "One bilinear pass of the inner-join fast path."},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "torch_fastjoin",
                                       nullptr, -1, Methods};

}  // namespace

PyMODINIT_FUNC PyInit_torch_fastjoin(void) {
  return PyModule_Create(&moduledef);
}

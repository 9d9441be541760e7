// CPython-API pass for ColumnarGroupByOperator's per-entry loops — the
// port's copy of the JAX package's native/fastgroup.cpp, under a module
// name of its own (torch_fastgroup), so that a process holding both
// packages never gets one package's module back for the other's.
//
// Two functions mirror the operator's Python implementation
// (pathway_tpu_torch/engine/operators.py) exactly:
//   gather(entries, intern, add_group, gval_pos, val_pos)
//       -> (codes, diffs, [value columns])
//     one pass over a tick's delta entries: group values intern to dense
//     codes through the typed-key dict (add_group python callback only on
//     first sight of a distinct value), diffs and reducer argument columns
//     come out as aligned lists for numpy.
//   emit(touched, cnts, kinds, cols, gvals, gkeys, last)
//       -> list of (gkey, row, diff)
//     one pass over the touched groups: build the new reduced row, diff it
//     against the last emitted row, record upserts.
//
// Built on first use by pathway_tpu_torch/native/build.py:load_extension;
// the operator runs its Python loops when the build fails.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

namespace {

static PyObject *gather(PyObject * /*self*/, PyObject *args) {
  PyObject *entries, *intern, *add_group, *gval_pos, *val_pos;
  if (!PyArg_ParseTuple(args, "O!O!OO!O!", &PyList_Type, &entries,
                        &PyDict_Type, &intern, &add_group, &PyTuple_Type,
                        &gval_pos, &PyTuple_Type, &val_pos))
    return nullptr;

  Py_ssize_t n = PyList_GET_SIZE(entries);
  Py_ssize_t ng = PyTuple_GET_SIZE(gval_pos);
  Py_ssize_t nv = PyTuple_GET_SIZE(val_pos);

  PyObject *codes = PyList_New(n);
  PyObject *diffs = PyList_New(n);
  PyObject *cols = PyList_New(nv);
  if (!codes || !diffs || !cols) goto fail;
  for (Py_ssize_t j = 0; j < nv; j++) {
    PyObject *col = PyList_New(n);
    if (!col) goto fail;
    PyList_SET_ITEM(cols, j, col);
  }

  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *e = PyList_GET_ITEM(entries, i);
    PyObject *row = PyTuple_GET_ITEM(e, 1);
    PyObject *d = PyTuple_GET_ITEM(e, 2);
    Py_INCREF(d);
    PyList_SET_ITEM(diffs, i, d);
    for (Py_ssize_t j = 0; j < nv; j++) {
      Py_ssize_t vp = PyLong_AsSsize_t(PyTuple_GET_ITEM(val_pos, j));
      // vp == -1 extracts the ROW KEY (argmin/argmax payload default)
      PyObject *v = vp < 0 ? PyTuple_GET_ITEM(e, 0)
                           : PyTuple_GET_ITEM(row, vp);
      Py_INCREF(v);
      PyList_SET_ITEM(PyList_GET_ITEM(cols, j), i, v);
    }
    // typed intern key: (type(v), v) / ((types...), (vals...))
    PyObject *tk, *gvals_obj = nullptr;
    if (ng == 1) {
      PyObject *v = PyTuple_GET_ITEM(
          row, PyLong_AsSsize_t(PyTuple_GET_ITEM(gval_pos, 0)));
      tk = PyTuple_Pack(2, (PyObject *)Py_TYPE(v), v);
    } else {
      PyObject *gvals = PyTuple_New(ng);
      PyObject *types = PyTuple_New(ng);
      if (!gvals || !types) {
        Py_XDECREF(gvals);
        Py_XDECREF(types);
        goto fail;
      }
      for (Py_ssize_t g = 0; g < ng; g++) {
        PyObject *v = PyTuple_GET_ITEM(
            row, PyLong_AsSsize_t(PyTuple_GET_ITEM(gval_pos, g)));
        PyTuple_SET_ITEM(gvals, g, Py_NewRef(v));
        PyTuple_SET_ITEM(types, g, Py_NewRef((PyObject *)Py_TYPE(v)));
      }
      tk = PyTuple_Pack(2, types, gvals);
      gvals_obj = gvals;  // borrowed out of tk for the add_group call
      Py_DECREF(types);
      Py_DECREF(gvals);
    }
    if (!tk) goto fail;
    PyObject *code = PyDict_GetItemWithError(intern, tk);
    if (code) {
      Py_INCREF(code);
    } else {
      if (PyErr_Occurred()) {
        Py_DECREF(tk);
        goto fail;
      }
      PyObject *gv;
      if (ng == 1) {
        gv = PyTuple_Pack(1, PyTuple_GET_ITEM(tk, 1));
      } else {
        gv = Py_NewRef(gvals_obj);
      }
      if (!gv) {
        Py_DECREF(tk);
        goto fail;
      }
      code = PyObject_CallFunctionObjArgs(add_group, tk, gv, NULL);
      Py_DECREF(gv);
      if (!code) {
        Py_DECREF(tk);
        goto fail;
      }
    }
    Py_DECREF(tk);
    PyList_SET_ITEM(codes, i, code);
  }
  {
    PyObject *out = PyTuple_Pack(3, codes, diffs, cols);
    Py_DECREF(codes);
    Py_DECREF(diffs);
    Py_DECREF(cols);
    return out;
  }

fail:
  Py_XDECREF(codes);
  Py_XDECREF(diffs);
  Py_XDECREF(cols);
  return nullptr;
}

// kinds: tuple of ints per reducer column: 0 = count, 1 = sum, 2 = avg
static PyObject *emit(PyObject * /*self*/, PyObject *args) {
  PyObject *touched, *cnts, *kinds, *cols, *gvals, *gkeys, *last;
  if (!PyArg_ParseTuple(args, "O!O!O!O!O!O!O!", &PyList_Type, &touched,
                        &PyList_Type, &cnts, &PyTuple_Type, &kinds,
                        &PyList_Type, &cols, &PyList_Type, &gvals,
                        &PyList_Type, &gkeys, &PyList_Type, &last))
    return nullptr;

  Py_ssize_t nt = PyList_GET_SIZE(touched);
  Py_ssize_t nk = PyTuple_GET_SIZE(kinds);
  PyObject *out = PyList_New(0);
  if (!out) return nullptr;
  PyObject *one = PyLong_FromLong(1);
  PyObject *neg = PyLong_FromLong(-1);
  if (!one || !neg) {
    Py_XDECREF(one);
    Py_XDECREF(neg);
    Py_DECREF(out);
    return nullptr;
  }

  for (Py_ssize_t i = 0; i < nt; i++) {
    Py_ssize_t code = PyLong_AsSsize_t(PyList_GET_ITEM(touched, i));
    PyObject *cobj = PyList_GET_ITEM(cnts, i);
    long long c = PyLong_AsLongLong(cobj);
    if (c == -1 && PyErr_Occurred()) goto fail;
    PyObject *newrow = nullptr;  // NULL means "group deleted"
    if (c > 0) {
      PyObject *gv = PyList_GET_ITEM(gvals, code);
      Py_ssize_t ngv = PyTuple_GET_SIZE(gv);
      newrow = PyTuple_New(ngv + nk);
      if (!newrow) goto fail;
      for (Py_ssize_t g = 0; g < ngv; g++)
        PyTuple_SET_ITEM(newrow, g, Py_NewRef(PyTuple_GET_ITEM(gv, g)));
      for (Py_ssize_t r = 0; r < nk; r++) {
        long kind = PyLong_AsLong(PyTuple_GET_ITEM(kinds, r));
        PyObject *red;
        if (kind == 0) {
          red = Py_NewRef(cobj);
        } else {
          PyObject *total = PyList_GET_ITEM(PyList_GET_ITEM(cols, r), i);
          if (kind == 2) {
            red = PyNumber_TrueDivide(total, cobj);
            if (!red) {
              Py_DECREF(newrow);
              goto fail;
            }
          } else {
            red = Py_NewRef(total);
          }
        }
        PyTuple_SET_ITEM(newrow, ngv + r, red);
      }
    }
    PyObject *old = PyList_GET_ITEM(last, code);  // Py_None = none emitted
    int same = 0;
    if (old != Py_None && newrow) {
      same = PyObject_RichCompareBool(old, newrow, Py_EQ);
      if (same < 0) {
        PyErr_Clear();
        same = 0;
      }
    } else if (old == Py_None && !newrow) {
      same = 1;
    }
    if (same) {
      Py_XDECREF(newrow);
      continue;
    }
    PyObject *gkey = PyList_GET_ITEM(gkeys, code);
    if (old != Py_None) {
      PyObject *e = PyTuple_Pack(3, gkey, old, neg);
      if (!e || PyList_Append(out, e) < 0) {
        Py_XDECREF(e);
        Py_XDECREF(newrow);
        goto fail;
      }
      Py_DECREF(e);
    }
    if (newrow) {
      PyObject *e = PyTuple_Pack(3, gkey, newrow, one);
      if (!e || PyList_Append(out, e) < 0) {
        Py_XDECREF(e);
        Py_DECREF(newrow);
        goto fail;
      }
      Py_DECREF(e);
      PyList_SetItem(last, code, newrow);  // steals newrow
    } else {
      PyList_SetItem(last, code, Py_NewRef(Py_None));
    }
  }
  Py_DECREF(one);
  Py_DECREF(neg);
  return out;

fail:
  Py_DECREF(one);
  Py_DECREF(neg);
  Py_DECREF(out);
  return nullptr;
}

static PyMethodDef Methods[] = {
    {"gather", gather, METH_VARARGS, "codes/diffs/value columns in one pass"},
    {"emit", emit, METH_VARARGS, "touched-group upsert emission"},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "torch_fastgroup",
                                       nullptr, -1, Methods};

}  // namespace

PyMODINIT_FUNC PyInit_torch_fastgroup(void) {
  return PyModule_Create(&moduledef);
}

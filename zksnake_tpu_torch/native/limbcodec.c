/* Native host codec: Python bigints <-> little-endian 16-bit limb buffers.
 *
 * The host<->device boundary of the TPU backend moves witness vectors,
 * polynomial coefficients and curve coordinates as (n, nl)-limb uint16
 * buffers (backend/limbs.py). The pure-Python codec pays per-element
 * attribute lookups and a million-way bytes join; this CPython extension
 * walks the list once with _PyLong_AsByteArray / _PyLong_FromByteArray.
 *
 * This is the rebuild's native runtime component in the spirit of the
 * reference's PyO3 boundary layer (upstream zksnake: src/lib.rs) — the compute
 * itself lives on the TPU, the native code feeds it.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

/* CPython 3.12 private API (stable within the baked interpreter) */
extern int _PyLong_AsByteArray(PyLongObject *v, unsigned char *bytes,
                               size_t n, int little_endian, int is_signed);
extern PyObject *_PyLong_FromByteArray(const unsigned char *bytes, size_t n,
                                       int little_endian, int is_signed);

static PyObject *
ints_to_bytes(PyObject *self, PyObject *args)
{
    PyObject *seq;
    Py_ssize_t nbytes;
    if (!PyArg_ParseTuple(args, "On", &seq, &nbytes))
        return NULL;

    PyObject *fast = PySequence_Fast(seq, "expected a sequence of ints");
    if (!fast)
        return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);

    PyObject *out = PyBytes_FromStringAndSize(NULL, n * nbytes);
    if (!out) {
        Py_DECREF(fast);
        return NULL;
    }
    unsigned char *buf = (unsigned char *)PyBytes_AS_STRING(out);

    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PySequence_Fast_GET_ITEM(fast, i);
        if (!PyLong_Check(item)) {
            Py_DECREF(fast);
            Py_DECREF(out);
            PyErr_SetString(PyExc_TypeError, "sequence items must be int");
            return NULL;
        }
        if (_PyLong_AsByteArray((PyLongObject *)item, buf + i * nbytes,
                                (size_t)nbytes, /*little_endian=*/1,
                                /*is_signed=*/0) < 0) {
            Py_DECREF(fast);
            Py_DECREF(out);
            return NULL; /* overflow or negative */
        }
    }
    Py_DECREF(fast);
    return out;
}

static PyObject *
bytes_to_ints(PyObject *self, PyObject *args)
{
    Py_buffer view;
    Py_ssize_t nbytes;
    if (!PyArg_ParseTuple(args, "y*n", &view, &nbytes))
        return NULL;
    if (nbytes <= 0 || view.len % nbytes != 0) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "buffer length not a multiple of element size");
        return NULL;
    }
    Py_ssize_t n = view.len / nbytes;
    PyObject *out = PyList_New(n);
    if (!out) {
        PyBuffer_Release(&view);
        return NULL;
    }
    const unsigned char *buf = (const unsigned char *)view.buf;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *v = _PyLong_FromByteArray(buf + i * nbytes, (size_t)nbytes,
                                            /*little_endian=*/1, /*is_signed=*/0);
        if (!v) {
            Py_DECREF(out);
            PyBuffer_Release(&view);
            return NULL;
        }
        PyList_SET_ITEM(out, i, v);
    }
    PyBuffer_Release(&view);
    return out;
}

static PyObject *
mulmod_scalar(PyObject *self, PyObject *args)
{
    /* batch (v * k) % p over a list of ints — the Montgomery-form scaling
     * loop of to_mont_host */
    PyObject *seq, *k, *p;
    if (!PyArg_ParseTuple(args, "OOO", &seq, &k, &p))
        return NULL;
    PyObject *fast = PySequence_Fast(seq, "expected a sequence of ints");
    if (!fast)
        return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    PyObject *out = PyList_New(n);
    if (!out) {
        Py_DECREF(fast);
        return NULL;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PySequence_Fast_GET_ITEM(fast, i);
        PyObject *prod = PyNumber_Multiply(item, k);
        if (!prod)
            goto fail;
        PyObject *rem = PyNumber_Remainder(prod, p);
        Py_DECREF(prod);
        if (!rem)
            goto fail;
        PyList_SET_ITEM(out, i, rem);
    }
    Py_DECREF(fast);
    return out;
fail:
    Py_DECREF(fast);
    Py_DECREF(out);
    return NULL;
}

static PyMethodDef Methods[] = {
    {"ints_to_bytes", ints_to_bytes, METH_VARARGS,
     "ints_to_bytes(seq, nbytes) -> bytes (little-endian, fixed width)"},
    {"bytes_to_ints", bytes_to_ints, METH_VARARGS,
     "bytes_to_ints(buf, nbytes) -> list[int]"},
    {"mulmod_scalar", mulmod_scalar, METH_VARARGS,
     "mulmod_scalar(seq, k, p) -> [(v*k) % p, ...]"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_limbcodec", NULL, -1, Methods,
};

PyMODINIT_FUNC
PyInit__limbcodec(void)
{
    return PyModule_Create(&moduledef);
}

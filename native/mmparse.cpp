// _mmparse — native MatrixMarket coordinate parser for bmsparse.
//
// The analogue of the reference's C++ host-side
// file ingestion (ifstream parse loop in the bmSpMatrix constructor,
// ref: src/bmSpMatrix.cu:112-161, and the legacy mmread_bmSparse,
// ref: src/reader.cu:49-110). Python-level line parsing is 20-50x slower
// than this single-pass strtol/strtod scan over a mmap'd buffer; file
// ingestion is on the benchmark-critical path (the reference times it as
// "Parsing data"), so it is implemented natively.
//
// parse(path) -> (rows: int32[nnz], cols: int32[nnz], vals: float64[nnz],
//                 num_rows: int, num_cols: int, sym: int)
//   sym: 0 = general, 1 = symmetric/hermitian (mirror off-diagonals),
//        2 = skew-symmetric (mirror with negation).
// Indices are converted 1-based -> 0-based. `pattern` files get vals = 1.0
// (CUSP's convention). Symmetric expansion itself is done by the caller.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <cctype>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Header {
    bool coordinate = false;
    bool pattern = false;
    bool complex_vals = false;
    int sym = 0;  // 0 general, 1 symmetric/hermitian, 2 skew
};

// Case-insensitive token match.
bool tok_is(const char* s, size_t n, const char* lit) {
    size_t m = std::strlen(lit);
    if (n != m) return false;
    for (size_t i = 0; i < n; ++i)
        if (std::tolower((unsigned char)s[i]) != lit[i]) return false;
    return true;
}

const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

const char* next_line(const char* p, const char* end) {
    while (p < end && *p != '\n') ++p;
    return p < end ? p + 1 : end;
}

bool parse_header(const char* p, const char* end, Header* h, std::string* err) {
    if (end - p < 14 || std::strncmp(p, "%%MatrixMarket", 14) != 0) {
        *err = "missing %%MatrixMarket banner";
        return false;
    }
    p += 14;
    const char* eol = p;
    while (eol < end && *eol != '\n') ++eol;
    // tokenize the banner line
    int ti = 0;
    while (p < eol) {
        p = skip_ws(p, eol);
        const char* t0 = p;
        while (p < eol && !std::isspace((unsigned char)*p)) ++p;
        if (p == t0) break;
        size_t n = (size_t)(p - t0);
        ++ti;
        switch (ti) {
            case 1:
                if (!tok_is(t0, n, "matrix")) { *err = "not a matrix file"; return false; }
                break;
            case 2:
                if (tok_is(t0, n, "coordinate")) h->coordinate = true;
                else if (tok_is(t0, n, "array")) h->coordinate = false;
                else { *err = "unknown format token"; return false; }
                break;
            case 3:
                if (tok_is(t0, n, "pattern")) h->pattern = true;
                else if (tok_is(t0, n, "complex")) h->complex_vals = true;
                else if (!(tok_is(t0, n, "real") || tok_is(t0, n, "integer") ||
                           tok_is(t0, n, "double"))) {
                    *err = "unknown field token"; return false;
                }
                break;
            case 4:
                if (tok_is(t0, n, "general")) h->sym = 0;
                else if (tok_is(t0, n, "symmetric") || tok_is(t0, n, "hermitian")) h->sym = 1;
                else if (tok_is(t0, n, "skew-symmetric")) h->sym = 2;
                else { *err = "unknown symmetry token"; return false; }
                break;
        }
    }
    return true;
}

PyObject* mm_parse(PyObject*, PyObject* args) {
    const char* path;
    if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;

    FILE* f = std::fopen(path, "rb");
    if (!f) {
        PyErr_Format(PyExc_FileNotFoundError, "cannot open %s", path);
        return nullptr;
    }
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<char> buf((size_t)size + 1);
    size_t got = std::fread(buf.data(), 1, (size_t)size, f);
    std::fclose(f);
    buf[got] = '\0';
    const char* p = buf.data();
    const char* end = p + got;

    Header h;
    std::string err;
    if (!parse_header(p, end, &h, &err)) {
        PyErr_Format(PyExc_ValueError, "%s: %s", path, err.c_str());
        return nullptr;
    }
    if (!h.coordinate) {
        PyErr_Format(PyExc_ValueError, "%s: only coordinate format supported", path);
        return nullptr;
    }

    // skip banner + comment lines
    p = next_line(p, end);
    while (p < end && (*p == '%' || *p == '\n')) p = next_line(p, end);

    // dims line: rows cols nnz
    char* q = nullptr;
    long nr = std::strtol(p, &q, 10);
    long nc = std::strtol(q, &q, 10);
    long nnz = std::strtol(q, &q, 10);
    if (nr <= 0 || nc <= 0 || nnz < 0) {
        PyErr_Format(PyExc_ValueError, "%s: bad dimensions line", path);
        return nullptr;
    }
    p = next_line(q, end);

    npy_intp n = (npy_intp)nnz;
    PyObject* rows_a = PyArray_SimpleNew(1, &n, NPY_INT32);
    PyObject* cols_a = PyArray_SimpleNew(1, &n, NPY_INT32);
    PyObject* vals_a = PyArray_SimpleNew(1, &n, NPY_FLOAT64);
    if (!rows_a || !cols_a || !vals_a) {
        Py_XDECREF(rows_a); Py_XDECREF(cols_a); Py_XDECREF(vals_a);
        return nullptr;
    }
    int32_t* rows = (int32_t*)PyArray_DATA((PyArrayObject*)rows_a);
    int32_t* cols = (int32_t*)PyArray_DATA((PyArrayObject*)cols_a);
    double* vals = (double*)PyArray_DATA((PyArrayObject*)vals_a);

    long i = 0;
    Py_BEGIN_ALLOW_THREADS
    for (; i < nnz && p < end; ++i) {
        char* e = nullptr;
        long r = std::strtol(p, &e, 10);
        long c = std::strtol(e, &e, 10);
        double v = 1.0;
        if (!h.pattern) {
            v = std::strtod(e, &e);
            if (h.complex_vals) std::strtod(e, &e);  // drop imaginary part
        }
        rows[i] = (int32_t)(r - 1);
        cols[i] = (int32_t)(c - 1);
        vals[i] = v;
        p = next_line(e, end);
    }
    Py_END_ALLOW_THREADS
    if (i != nnz) {
        Py_DECREF(rows_a); Py_DECREF(cols_a); Py_DECREF(vals_a);
        PyErr_Format(PyExc_ValueError, "%s: expected %ld entries, got %ld",
                     path, nnz, i);
        return nullptr;
    }

    PyObject* out = Py_BuildValue("(NNNlli)", rows_a, cols_a, vals_a,
                                  nr, nc, h.sym);
    return out;
}

PyMethodDef methods[] = {
    {"parse", mm_parse, METH_VARARGS,
     "parse(path) -> (rows, cols, vals, num_rows, num_cols, sym)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_mmparse",
    "native MatrixMarket coordinate parser", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__mmparse(void) {
    import_array();
    return PyModule_Create(&moduledef);
}

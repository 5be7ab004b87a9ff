// Specialized JSON scanners for the serving hot path.
//
// The reference's HTTP layer is axum/serde (Rust, ~zero-copy); Python's
// json module's parse of one 768-d embedding body is a large share of
// a single-process server's per-request host time.  These scanners
// parse the two hot fields of PostIndexAnnRequest — "embedding":
// [floats] and "limit": int — directly from the raw body.
//
// Safety contract: they are STRICT and conservative.  Any structural
// surprise (key absent, key not unique, value not a flat numeric
// array, trailing garbage between numbers) returns -1 and the caller
// falls back to Python json.loads for full-fidelity error handling.
// Raw bytes `"embedding"` inside a valid JSON document can only be a
// key or an exact string value (escaped quotes never produce the raw
// byte sequence), and the value case fails the ':'-follows check.

#include <cstdlib>
#include <cstring>

namespace {

const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
        ++p;
    return p;
}

// find `"key"` (with quotes) in [p, end); returns nullptr if absent or
// not unique.
const char* find_unique_key(const char* p, const char* end, const char* key) {
    size_t klen = strlen(key);
    const char* hit = nullptr;
    while (p + klen <= end) {
        const char* f = static_cast<const char*>(
            memmem(p, end - p, key, klen));
        if (!f) break;
        if (hit) return nullptr;  // not unique -> fall back
        hit = f;
        p = f + klen;
    }
    return hit;
}

}  // namespace

extern "C" {

// Parse `"<key>": [f, f, ...]` out of body.  Returns the count of
// floats written to out (<= cap), or -1 on any structural surprise
// (caller falls back to a full JSON parse).  A count > cap also
// returns -1 (embedding longer than the caller's buffer).
long json_parse_floats(const char* body, long len, const char* key,
                       float* out, long cap) {
    const char* end = body + len;
    const char* p = find_unique_key(body, end, key);
    if (!p) return -1;
    p += strlen(key);
    p = skip_ws(p, end);
    if (p >= end || *p != ':') return -1;
    p = skip_ws(p + 1, end);
    if (p >= end || *p != '[') return -1;
    ++p;
    long n = 0;
    p = skip_ws(p, end);
    if (p < end && *p == ']') return 0;  // empty array
    while (p < end) {
        char* q;
        // strtod reads past `end` only if the body isn't NUL-terminated
        // mid-number at the very end; aiohttp bodies are bytes objects
        // (NUL-terminated by CPython), so this is safe.
        double v = strtod(p, &q);
        if (q == p) return -1;  // not a number (null/nan/inf/garbage)
        if (n >= cap) return -1;
        out[n++] = static_cast<float>(v);
        p = skip_ws(q, end);
        if (p >= end) return -1;
        if (*p == ']') return n;
        if (*p != ',') return -1;
        p = skip_ws(p + 1, end);
    }
    return -1;
}

// Parse `"<key>": <int>`.  Returns the value, or `defval` if the key is
// absent, or -1 on a malformed value (caller falls back).
long json_parse_int(const char* body, long len, const char* key,
                    long defval) {
    const char* end = body + len;
    const char* p = find_unique_key(body, end, key);
    if (!p) return defval;
    p += strlen(key);
    p = skip_ws(p, end);
    if (p >= end || *p != ':') return -1;
    p = skip_ws(p + 1, end);
    if (p >= end) return -1;
    char* q;
    long v = strtol(p, &q, 10);
    if (q == p || v < 0) return -1;
    // a float here (e.g. "limit": 1.5) must not silently truncate
    if (q < end && (*q == '.' || *q == 'e' || *q == 'E')) return -1;
    return v;
}

}  // extern "C"

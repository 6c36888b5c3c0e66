// Native dataset baker: ARC-format JSON -> packed task-bank arrays.
//
// The port's copy of arcle_tpu/native/bake.cpp, with the same behaviour:
// parsing task files and packing every train/test pair into fixed
// [30, 30] int8 grids, exposed through ctypes, with the json path of
// loaders/loader.py as the fallback.
//
// Grammar handled: the ARC task JSON subset —
//   {"train": [{"input": [[int,...],...], "output": [[...]]}, ...],
//    "test":  [...]}
// plus Mini-ARC's quirk of literal `null` cells (treated as 0, matching
// the reference's text replacement, loader.py:137).
//
// Built lazily by arcle_tpu_torch/native/__init__.py into _build/.

#include <cstdint>
#include <cstring>
#include <string>

namespace {

constexpr int H = 30, W = 30;

struct Cursor {
    const char* p;
    const char* end;

    void skip_ws() {
        while (p < end && (*p == ' ' || *p == '\n' || *p == '\t' ||
                           *p == '\r')) {
            ++p;
        }
    }
    bool at(char c) {
        skip_ws();
        return p < end && *p == c;
    }
    bool eat(char c) {
        if (!at(c)) return false;
        ++p;
        return true;
    }
    bool find_key(const char* key) {
        // scan forward for "key" at the current nesting level is overkill
        // for this fixed grammar; a plain substring search suffices because
        // ARC task files contain no nested objects with these names.
        size_t n = std::strlen(key);
        for (const char* q = p; q + n + 2 <= end; ++q) {
            if (*q == '"' && std::memcmp(q + 1, key, n) == 0 &&
                q[n + 1] == '"') {
                p = q + n + 2;
                return true;
            }
        }
        return false;
    }
    int parse_int() {
        skip_ws();
        bool neg = p < end && *p == '-';
        if (neg) ++p;
        int v = 0;
        while (p < end && *p >= '0' && *p <= '9') {
            v = v * 10 + (*p - '0');
            ++p;
        }
        return neg ? -v : v;
    }
};

// Parse one [[...], ...] grid into out (zero-padded HxW), returns rows<<8|cols,
// or -1 on malformed input / oversize grids.
int parse_grid(Cursor& c, int8_t* out) {
    std::memset(out, 0, H * W);
    if (!c.eat('[')) return -1;
    int rows = 0, cols = 0;
    while (!c.at(']')) {
        if (!c.eat('[')) return -1;
        int col = 0;
        while (!c.at(']')) {
            c.skip_ws();
            int v;
            if (c.p + 4 <= c.end && std::memcmp(c.p, "null", 4) == 0) {
                v = 0;              // Mini-ARC null cells
                c.p += 4;
            } else if (*c.p == '"') {   // "0" strings post-replacement
                ++c.p;
                v = c.parse_int();
                if (!c.eat('"')) return -1;
            } else {
                const char* before = c.p;
                v = c.parse_int();
                if (c.p == before) return -1;   // non-numeric cell token
            }
            if (rows < H && col < W) out[rows * W + col] = (int8_t)v;
            ++col;
            c.eat(',');
        }
        c.eat(']');
        if (rows == 0) cols = col;
        ++rows;
        c.eat(',');
    }
    c.eat(']');
    if (rows > H || cols > W || rows == 0 || cols == 0) return -1;
    return (rows << 8) | cols;
}

}  // namespace

extern "C" {

// Parse one task-file text. Appends up to max_pairs (input, output) pairs:
//   grids:   [max_pairs, 2, 900] int8
//   dims:    [max_pairs, 2, 2]   int32
//   splits:  [max_pairs]         int32   (0 = train pair, 1 = test pair)
// Returns the number of pairs written, or -1 on parse failure.
int bake_task(const char* text, long len, int8_t* grids, int* dims,
              int* splits, int max_pairs) {
    int written = 0;
    for (int split = 0; split < 2; ++split) {
        Cursor c{text, text + len};
        if (!c.find_key(split == 0 ? "train" : "test")) continue;
        if (!c.eat(':')) return -1;
        if (!c.eat('[')) return -1;
        while (!c.at(']')) {
            // refuse rather than truncate: caller falls back to Python
            if (written >= max_pairs) return -1;
            if (!c.eat('{')) return -1;
            // "input" ... "output" within this pair object
            Cursor pair = c;
            if (!pair.find_key("input") || !pair.eat(':')) return -1;
            int8_t* gi = grids + (size_t)written * 2 * H * W;
            int di = parse_grid(pair, gi);
            if (di < 0) return -1;
            Cursor pout = c;
            if (!pout.find_key("output") || !pout.eat(':')) return -1;
            int do_ = parse_grid(pout, gi + H * W);
            if (do_ < 0) return -1;
            dims[written * 4 + 0] = di >> 8;
            dims[written * 4 + 1] = di & 0xff;
            dims[written * 4 + 2] = do_ >> 8;
            dims[written * 4 + 3] = do_ & 0xff;
            splits[written] = split;
            ++written;
            // advance main cursor past this pair object
            c.p = (pair.p > pout.p ? pair.p : pout.p);
            while (c.p < c.end && *c.p != '}') ++c.p;
            c.eat('}');
            c.eat(',');
        }
        c.eat(']');
    }
    return written;
}

}  // extern "C"

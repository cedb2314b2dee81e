// Host kernels of the stat_fish tail: the Edmonds-Karp min-cut partition on
// the pixel graph (min-cut splitting of touching nuclei) and the
// priority-flood marker watershed.  A copy of the JAX package's
// ecseg_tpu/native/cc_maxflow.cpp without its connected-component labeler
// (scipy labels on the host here).  Semantics are those of the Python twins
// in ecseg_torch/ops/maxflow.py and ops/watershed.py: the same raster-order
// graph construction, FIFO BFS edge order and (value, age) heap order,
// which tests/test_torch_watershed.py holds bit for bit.
//
// A plain C ABI for ctypes, built at first use by ecseg_torch/_build.py
// (host_library).

#include <algorithm>
#include <cstdint>
#include <cstdlib>  // std::abs(long long) -- do not rely on transitive includes
#include <cstring>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Max-flow min-cut partition.
//
// Graph construction in raster order over `img` (H x W, nonzero =
// foreground): for each foreground pixel that is neither start nor target,
// first a super edge (source->pixel if within L1 `dist` of start, ELSE
// pixel->sink if within dist of target), then unit edges to its 4 neighbors
// in order (+1,0), (0,+1), (-1,0), (0,-1).  FIFO BFS iterating adjacency in
// insertion order.  Writes the residual-reachable-from-start set into
// `group1` (1/0).  Returns the max flow value.
// ---------------------------------------------------------------------------

struct FlowGraph {
    std::vector<std::vector<int32_t>> adj;
    std::vector<int32_t> to;
    std::vector<int8_t> cap;
    std::vector<int8_t> flow;

    explicit FlowGraph(int64_t n_nodes) : adj(n_nodes) {}

    void add_pair(int32_t u, int32_t v, int8_t c) {
        int32_t e = (int32_t)to.size();
        to.push_back(v);
        to.push_back(u);
        cap.push_back(c);
        cap.push_back(0);
        flow.push_back(0);
        flow.push_back(0);
        adj[u].push_back(e);
        adj[v].push_back(e + 1);
    }
};

int64_t maxflow_partition(const int32_t* img, int64_t H, int64_t W,
                          int64_t sy, int64_t sx, int64_t ty, int64_t tx,
                          int64_t dist, int32_t* group1) {
    const int64_t n = H * W;
    FlowGraph g(n);
    const int32_t s_id = (int32_t)(sy * W + sx);
    const int32_t t_id = (int32_t)(ty * W + tx);

    const int64_t dy[4] = {1, 0, -1, 0};
    const int64_t dx[4] = {0, 1, 0, -1};

    for (int64_t i = 0; i < H; ++i) {
        for (int64_t j = 0; j < W; ++j) {
            if (!img[i * W + j]) continue;
            if (i == sy && j == sx) continue;
            if (i == ty && j == tx) continue;
            const int32_t id = (int32_t)(i * W + j);
            if (std::abs(sy - i) + std::abs(sx - j) <= dist) {
                g.add_pair(s_id, id, 1);
            } else if (std::abs(ty - i) + std::abs(tx - j) <= dist) {
                g.add_pair(id, t_id, 1);
            }
            for (int k = 0; k < 4; ++k) {
                const int64_t ni = i + dy[k], nj = j + dx[k];
                if (ni >= 0 && ni < H && nj >= 0 && nj < W &&
                    img[ni * W + nj]) {
                    g.add_pair(id, (int32_t)(ni * W + nj), 1);
                }
            }
        }
    }

    std::vector<int32_t> prev_edge(n, -1);
    std::vector<uint8_t> seen(n, 0);
    std::vector<int32_t> fifo;
    fifo.reserve(n);

    auto bfs = [&](bool reachable_only) -> bool {
        std::fill(seen.begin(), seen.end(), 0);
        fifo.clear();
        fifo.push_back(s_id);
        seen[s_id] = 1;
        for (size_t qi = 0; qi < fifo.size(); ++qi) {
            const int32_t curr = fifo[qi];
            for (int32_t e : g.adj[curr]) {
                const int32_t end = g.to[e];
                if (!seen[end] && g.flow[e] < g.cap[e]) {
                    seen[end] = 1;
                    prev_edge[end] = e;
                    fifo.push_back(end);
                }
            }
        }
        return !reachable_only && seen[t_id];
    };

    int64_t total = 0;
    while (bfs(false)) {
        // trace path; unit capacities -> bottleneck is always 1 here, but we
        // compute it anyway for exactness
        int8_t df = 127;
        for (int32_t e = prev_edge[t_id];;) {
            df = std::min(df, (int8_t)(g.cap[e] - g.flow[e]));
            const int32_t start_node = g.to[e ^ 1];
            if (start_node == s_id) break;
            e = prev_edge[start_node];
        }
        for (int32_t e = prev_edge[t_id];;) {
            g.flow[e] += df;
            g.flow[e ^ 1] -= df;
            const int32_t start_node = g.to[e ^ 1];
            if (start_node == s_id) break;
            e = prev_edge[start_node];
        }
        total += df;
    }

    bfs(true);
    for (int64_t i = 0; i < n; ++i) group1[i] = seen[i] ? 1 : 0;
    return total;
}

// ---------------------------------------------------------------------------
// Priority-flood watershed, (value, age) min-heap, optional watershed line.
// Matches ecseg_torch.ops.watershed.watershed_py (see its docstring).
// ---------------------------------------------------------------------------

struct WsItem {
    double value;
    int64_t age;
    int32_t y, x, sy, sx;
};
struct WsCmp {
    bool operator()(const WsItem& a, const WsItem& b) const {
        if (a.value != b.value) return a.value > b.value;
        return a.age > b.age;
    }
};

void watershed(const double* image, const int64_t* markers_in,
               const uint8_t* mask, int64_t H, int64_t W, int connectivity,
               int wsl, int64_t* output) {
    const int64_t n = H * W;
    std::vector<uint8_t> lines(wsl ? n : 0, 0);
    for (int64_t i = 0; i < n; ++i)
        output[i] = mask[i] ? markers_in[i] : 0;

    static const int off4[4][2] = {{-1, 0}, {0, -1}, {0, 1}, {1, 0}};
    static const int off8[8][2] = {{-1, -1}, {-1, 0}, {-1, 1}, {0, -1},
                                   {0, 1},  {1, -1}, {1, 0},  {1, 1}};
    const int n_off = (connectivity == 1) ? 4 : 8;
    const int(*offs)[2] = (connectivity == 1) ? off4 : off8;

    std::priority_queue<WsItem, std::vector<WsItem>, WsCmp> heap;
    int64_t age = 0;
    for (int64_t y = 0; y < H; ++y)
        for (int64_t x = 0; x < W; ++x)
            if (output[y * W + x] != 0) {
                heap.push({image[y * W + x], age++, (int32_t)y, (int32_t)x,
                           (int32_t)y, (int32_t)x});
            }

    while (!heap.empty()) {
        WsItem e = heap.top();
        heap.pop();
        const int64_t idx = (int64_t)e.y * W + e.x;
        if (wsl) {
            if (output[idx] != 0 && !(e.y == e.sy && e.x == e.sx)) continue;
            output[idx] = output[(int64_t)e.sy * W + e.sx];
        }
        for (int k = 0; k < n_off; ++k) {
            const int64_t ny = e.y + offs[k][0], nx = e.x + offs[k][1];
            if (ny < 0 || ny >= H || nx < 0 || nx >= W) continue;
            const int64_t nidx = ny * W + nx;
            if (!mask[nidx]) continue;
            if (wsl && output[nidx] != 0 && output[nidx] != output[idx])
                lines[idx] = 1;
            if (output[nidx] != 0) continue;
            ++age;
            if (!wsl) output[nidx] = output[idx];
            heap.push({image[nidx], age, (int32_t)ny, (int32_t)nx,
                       (int32_t)e.y, (int32_t)e.x});
        }
    }

    if (wsl)
        for (int64_t i = 0; i < n; ++i)
            if (lines[i]) output[i] = 0;
}

}  // extern "C"

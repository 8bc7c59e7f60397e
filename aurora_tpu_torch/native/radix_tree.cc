// Native radix prefix cache over KV slots.
//
// C++ twin of aurora_tpu_torch/serve/radix_cache.py (a copy of
// aurora_tpu/native/radix_tree.cc). The serving control loop calls
// match/insert on every request admission; for long prompts (video
// placeholder prefixes run to thousands of tokens) the token-compare walk
// is the hot host path, so it lives here. Exposed through a C ABI consumed
// via ctypes (aurora_tpu_torch/native/__init__.py).
//
// Build: aurora_tpu_torch/native/__init__.py `ensure_built` runs
// g++ -O2 -shared -fPIC -std=c++17 into build/native/ at the repository
// root on first use.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <queue>
#include <vector>

namespace {

struct Node {
  std::map<int64_t, Node*> children;  // first token -> child
  Node* parent = nullptr;
  std::vector<int64_t> key;
  std::vector<int32_t> slots;
  int64_t lock_ref = 0;
  uint64_t last_access = 0;
};

struct Tree {
  Node root;
  uint64_t clock = 0;
  int64_t evictable = 0;

  Tree() { root.lock_ref = 1; }

  ~Tree() { free_subtree(&root); }

  static void free_subtree(Node* n) {
    for (auto& kv : n->children) {
      free_subtree(kv.second);
      delete kv.second;
    }
    n->children.clear();
  }

  static size_t shared_len(const std::vector<int64_t>& a,
                           const int64_t* b, size_t nb) {
    size_t n = std::min(a.size(), nb);
    for (size_t i = 0; i < n; ++i)
      if (a[i] != b[i]) return i;
    return n;
  }

  Node* split(Node* child, size_t n) {
    Node* upper = new Node();
    upper->parent = child->parent;
    upper->key.assign(child->key.begin(), child->key.begin() + n);
    upper->slots.assign(child->slots.begin(), child->slots.begin() + n);
    upper->lock_ref = child->lock_ref;
    upper->last_access = child->last_access;
    upper->children[child->key[n]] = child;
    child->parent->children[child->key[0]] = upper;
    child->parent = upper;
    child->key.erase(child->key.begin(), child->key.begin() + n);
    child->slots.erase(child->slots.begin(), child->slots.begin() + n);
    return upper;
  }

  // → number of matched slots written to out; *out_node = deepest node.
  int64_t match(const int64_t* tokens, int64_t n, int32_t* out,
                int64_t cap, Node** out_node) {
    Node* node = &root;
    int64_t written = 0;
    const int64_t* key = tokens;
    int64_t remaining = n;
    while (remaining > 0) {
      auto it = node->children.find(key[0]);
      if (it == node->children.end()) break;
      Node* child = it->second;
      child->last_access = ++clock;
      size_t m = shared_len(child->key, key, (size_t)remaining);
      if ((int64_t)m < (int64_t)child->key.size()) {
        child = split(child, m);
        for (size_t i = 0; i < child->slots.size() && written < cap; ++i)
          out[written++] = child->slots[i];
        node = child;
        break;
      }
      for (size_t i = 0; i < child->slots.size() && written < cap; ++i)
        out[written++] = child->slots[i];
      node = child;
      key += m;
      remaining -= (int64_t)m;
    }
    *out_node = node;
    return written;
  }

  // → number of PREFIX tokens that were already cached.
  int64_t insert(Node* node, const int64_t* key, const int32_t* slots,
                 int64_t n) {
    node->last_access = ++clock;
    if (n == 0) return 0;
    auto it = node->children.find(key[0]);
    if (it == node->children.end()) {
      Node* child = new Node();
      child->parent = node;
      child->key.assign(key, key + n);
      child->slots.assign(slots, slots + n);
      child->last_access = clock;
      node->children[key[0]] = child;
      evictable += n;
      return 0;
    }
    Node* child = it->second;
    size_t m = shared_len(child->key, key, (size_t)n);
    if ((int64_t)m < (int64_t)child->key.size()) child = split(child, m);
    return (int64_t)m + insert(child, key + m, slots + m, n - m);
  }

  void lock(Node* node, int64_t delta) {
    while (node != nullptr && node != &root) {
      if (node->lock_ref == 0 && delta > 0)
        evictable -= (int64_t)node->key.size();
      node->lock_ref += delta;
      if (node->lock_ref == 0 && delta < 0)
        evictable += (int64_t)node->key.size();
      node = node->parent;
    }
  }

  void collect_leaves(Node* n, std::vector<Node*>* out) {
    if (n->children.empty()) {
      if (n != &root && n->lock_ref == 0) out->push_back(n);
      return;
    }
    for (auto& kv : n->children) collect_leaves(kv.second, out);
  }

  int64_t evict(int64_t want, int32_t* out_slots, int64_t cap) {
    auto cmp = [](Node* a, Node* b) {
      return a->last_access > b->last_access;  // min-heap by access time
    };
    std::vector<Node*> leaves;
    collect_leaves(&root, &leaves);
    std::priority_queue<Node*, std::vector<Node*>, decltype(cmp)> heap(
        cmp, leaves);
    int64_t freed = 0;
    while (!heap.empty() && freed < want) {
      Node* node = heap.top();
      heap.pop();
      if (!node->children.empty() || node->lock_ref > 0 || node == &root)
        continue;
      // never drop slots: stop when the out buffer can't take this node
      if (freed + (int64_t)node->slots.size() > cap) break;
      for (size_t i = 0; i < node->slots.size(); ++i)
        out_slots[freed++] = node->slots[i];
      evictable -= (int64_t)node->key.size();
      Node* parent = node->parent;
      parent->children.erase(node->key[0]);
      delete node;
      if (parent != &root && parent->children.empty() &&
          parent->lock_ref == 0)
        heap.push(parent);
    }
    return freed;
  }

  int64_t total(Node* n) {
    int64_t t = (n == &root) ? 0 : (int64_t)n->key.size();
    for (auto& kv : n->children) t += total(kv.second);
    return t;
  }
};

}  // namespace

extern "C" {

void* rt_new() { return new Tree(); }

void rt_delete(void* h) { delete static_cast<Tree*>(h); }

int64_t rt_match(void* h, const int64_t* tokens, int64_t n, int32_t* out,
                 int64_t cap, void** out_node) {
  Node* node = nullptr;
  int64_t m = static_cast<Tree*>(h)->match(tokens, n, out, cap, &node);
  *out_node = node;
  return m;
}

int64_t rt_insert(void* h, const int64_t* tokens, const int32_t* slots,
                  int64_t n) {
  Tree* t = static_cast<Tree*>(h);
  return t->insert(&t->root, tokens, slots, n);
}

void rt_lock(void* h, void* node, int64_t delta) {
  static_cast<Tree*>(h)->lock(static_cast<Node*>(node), delta);
}

int64_t rt_evict(void* h, int64_t want, int32_t* out, int64_t cap) {
  return static_cast<Tree*>(h)->evict(want, out, cap);
}

int64_t rt_total_cached(void* h) {
  Tree* t = static_cast<Tree*>(h);
  return t->total(&t->root);
}

int64_t rt_evictable(void* h) {
  return static_cast<Tree*>(h)->evictable;
}

}  // extern "C"

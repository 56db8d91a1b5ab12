"""Word2Vec: skip-gram embeddings with negative sampling (the port of
`mmlspark_tpu/feature/word2vec.py`).

Counterpart of Spark's Word2Vec as used by the reference's notebook 202
(`notebooks/samples/202 - Amazon Book Reviews - Word2Vec.ipynb`): fit token
embeddings on a corpus, then represent each document as the mean of its
word vectors (Spark's Word2VecModel.transform semantics).

Pair generation (center/context windows, the unigram^0.75 negative table)
is one vectorized host pass, and the numpy draws (initial vectors, the
pass's permutation, each batch's negatives) come in the JAX package's
order from the same seed.  Training is plain SGD as torch ops on the
stage's device: each batch's gradient of the mean skip-gram loss, taken
in closed form, is added into the embedding rows it touches
(`index_put_(accumulate=True)`, which adds in a fixed order), then the
step is taken.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.device import exact_f32, resolve_device
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.pipeline import Estimator, JaxTwin, Transformer
from mmlspark_tpu_torch.core.table import DataTable


class Word2VecModel(JaxTwin, Transformer):
    """Document vectors = mean of fitted word vectors (Spark semantics)."""

    inputCol = Param(None, "token-list column", ptype=str, required=True)
    outputCol = Param("w2v", "document-vector output column", ptype=str)

    def __init__(self, vocab: Optional[list[str]] = None,
                 vectors: Optional[np.ndarray] = None, **kw):
        super().__init__(**kw)
        self._vocab = list(vocab or [])
        self._index = {w: i for i, w in enumerate(self._vocab)}
        self._vectors = (np.asarray(vectors, np.float32)
                         if vectors is not None else None)

    @property
    def vectors(self) -> np.ndarray:
        return self._vectors

    @property
    def vocabulary(self) -> list[str]:
        return list(self._vocab)

    def word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self._index.get(word)
        return None if i is None else self._vectors[i]

    def find_synonyms(self, word: str, num: int = 5) -> list[tuple[str, float]]:
        """Nearest vocabulary words by cosine similarity (Spark's
        findSynonyms)."""
        v = self.word_vector(word)
        if v is None:
            raise KeyError(f"'{word}' not in the fitted vocabulary")
        norms = np.linalg.norm(self._vectors, axis=1) * np.linalg.norm(v)
        sims = self._vectors @ v / np.maximum(norms, 1e-12)
        order = np.argsort(-sims)
        out = [(self._vocab[i], float(sims[i])) for i in order
               if self._vocab[i] != word]
        return out[:num]

    def transform(self, table: DataTable) -> DataTable:
        self._check_required()
        dim = self._vectors.shape[1]
        docs = np.zeros((table.num_rows, dim), np.float32)
        for r, toks in enumerate(table[self.inputCol]):
            idx = [self._index[t] for t in toks if t in self._index]
            if idx:
                docs[r] = self._vectors[idx].mean(axis=0)
        return table.with_column(self.outputCol, docs)

    def _save_extra(self, path: str) -> None:
        np.save(os.path.join(path, "vectors.npy"), self._vectors)
        with open(os.path.join(path, "vocab.json"), "w") as f:
            json.dump(self._vocab, f)

    def _load_extra(self, path: str, **_init_kwargs) -> None:
        self._vectors = np.load(os.path.join(path, "vectors.npy"))
        with open(os.path.join(path, "vocab.json")) as f:
            self._vocab = json.load(f)
        self._index = {w: i for i, w in enumerate(self._vocab)}


class Word2Vec(JaxTwin, Estimator):
    """Fit skip-gram embeddings with negative sampling on `device` (a
    run-time setting, not a Param)."""

    inputCol = Param(None, "token-list column", ptype=str, required=True)
    outputCol = Param("w2v", "document-vector output column", ptype=str)
    vectorSize = Param(100, "embedding dimension", ptype=int)
    windowSize = Param(5, "context window radius", ptype=int)
    minCount = Param(5, "minimum token frequency to enter the vocabulary",
                     ptype=int)
    maxIter = Param(1, "passes over the generated pairs", ptype=int)
    stepSize = Param(0.025, "learning rate", ptype=float)
    numNegatives = Param(5, "negative samples per positive pair", ptype=int)
    seed = Param(0, "rng seed", ptype=int)

    def __init__(self, device="cuda", **kw):
        super().__init__(**kw)
        self.device = resolve_device(device)

    def fit(self, table: DataTable) -> Word2VecModel:
        self._check_required()
        docs = [list(t) for t in table[self.inputCol]]
        # vocabulary over minCount (Spark's vocab pruning)
        flat = [t for d in docs for t in d]
        words, counts = np.unique(np.asarray(flat, object), return_counts=True)
        keep = counts >= self.minCount
        vocab = [str(w) for w in words[keep]]
        index = {w: i for i, w in enumerate(vocab)}
        v = len(vocab)
        dim = self.vectorSize
        rng = np.random.default_rng(self.seed)
        if v == 0:
            return Word2VecModel(vocab, np.zeros((0, dim), np.float32),
                                 inputCol=self.inputCol,
                                 outputCol=self.outputCol)

        # one vectorized pass: all (center, context) pairs in all windows
        centers, contexts = [], []
        win = self.windowSize
        for d in docs:
            ids = np.asarray([index[t] for t in d if t in index], np.int32)
            n = len(ids)
            for off in range(1, win + 1):
                if n > off:
                    centers.append(ids[:-off]); contexts.append(ids[off:])
                    centers.append(ids[off:]);  contexts.append(ids[:-off])
        if not centers:
            return Word2VecModel(vocab, np.zeros((v, dim), np.float32),
                                 inputCol=self.inputCol,
                                 outputCol=self.outputCol)
        centers = np.concatenate(centers)
        contexts = np.concatenate(contexts)

        # unigram^0.75 negative-sampling table
        freq = counts[keep].astype(np.float64) ** 0.75
        neg_p = freq / freq.sum()

        init = rng.uniform(-0.5 / dim, 0.5 / dim, (v, dim)).astype(
            np.float32)
        lr, k_neg, dev = float(self.stepSize), self.numNegatives, self.device
        batch = 4096
        n_pairs = len(centers)
        pad = (-n_pairs) % batch
        with torch.inference_mode(), exact_f32():
            in_vecs = torch.as_tensor(init, device=dev)
            out_vecs = torch.zeros((v, dim), dtype=torch.float32,
                                   device=dev)
            centers_d = torch.as_tensor(centers, device=dev).long()
            contexts_d = torch.as_tensor(contexts, device=dev).long()
            for _ in range(self.maxIter):
                # wrap-around padding keeps every batch at one shape;
                # negatives are drawn per batch, as the JAX package does
                order = np.resize(rng.permutation(n_pairs), n_pairs + pad)
                order_d = torch.as_tensor(order, device=dev)
                for s0 in range(0, len(order), batch):
                    sl = order_d[s0:s0 + batch]
                    negs = rng.choice(v, size=(batch, k_neg),
                                      p=neg_p).astype(np.int32)
                    _sgd_step(in_vecs, out_vecs, centers_d[sl],
                              contexts_d[sl],
                              torch.as_tensor(negs, device=dev).long(), lr)
            vectors = in_vecs.cpu().numpy()
        return Word2VecModel(vocab, vectors, inputCol=self.inputCol,
                             outputCol=self.outputCol)


def _sgd_step(in_vecs: torch.Tensor, out_vecs: torch.Tensor,
              c: torch.Tensor, o: torch.Tensor, neg: torch.Tensor,
              lr: float) -> None:
    """One SGD step on -(mean log s(v_c . u_o) + mean sum_k log s(-v_c .
    u_k)), in place."""
    b = c.shape[0]
    vc, uo, un = in_vecs[c], out_vecs[o], out_vecs[neg]    # (B,D), (B,K,D)
    s_pos = (vc * uo).sum(-1)
    s_neg = torch.einsum("bd,bkd->bk", vc, un)
    d_pos = -torch.sigmoid(-s_pos) / b                     # dL / d s_pos
    d_neg = torch.sigmoid(s_neg) / b                       # dL / d s_neg
    g_vc = d_pos[:, None] * uo + torch.einsum("bk,bkd->bd", d_neg, un)
    g_uo = d_pos[:, None] * vc
    g_un = d_neg[:, :, None] * vc[:, None, :]
    g_in = torch.zeros_like(in_vecs)
    g_out = torch.zeros_like(out_vecs)
    g_in.index_put_((c,), g_vc, accumulate=True)
    g_out.index_put_((o,), g_uo, accumulate=True)
    g_out.index_put_((neg.reshape(-1),), g_un.reshape(-1, g_un.shape[-1]),
                     accumulate=True)
    in_vecs.add_(g_in, alpha=-lr)
    out_vecs.add_(g_out, alpha=-lr)

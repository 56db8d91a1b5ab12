"""Configurable text featurization chain (the port of
`mmlspark_tpu/feature/text.py`; host work, as there).

TPU-native counterpart of the reference's text-featurizer
(TextFeaturizer.scala:18-290): RegexTokenizer → StopWordsRemover → NGram →
HashingTF → IDF, each stage optional and chained by param rewiring.  Every
stage is an independent pipeline Transformer/Estimator here too, so they
compose outside TextFeaturizer as well.

Token columns are object columns of python string lists; hashed output is a
sparse-row object column (see feature/hashing.py) carrying
`num_features`/`binary` in column metadata.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.pipeline import (Estimator, JaxTwin,
                                              PipelineModel, Transformer)
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.core.table import object_column as _object_column
from mmlspark_tpu_torch.feature.hashing import (concat_sparse_rows,
                                                hash_token_lists)

# A standard English stop-word list (the usual Porter/SMART subset Spark's
# loadDefaultStopWords("english") ships; reference TextFeaturizer.scala:245-253).
ENGLISH_STOP_WORDS = frozenset("""
a about above after again against all am an and any are aren't as at be
because been before being below between both but by can't cannot could
couldn't did didn't do does doesn't doing don't down during each few for from
further had hadn't has hasn't have haven't having he he'd he'll he's her here
here's hers herself him himself his how how's i i'd i'll i'm i've if in into
is isn't it it's its itself let's me more most mustn't my myself no nor not of
off on once only or other ought our ours ourselves out over own same shan't
she she'd she'll she's should shouldn't so some such than that that's the
their theirs them themselves then there there's these they they'd they'll
they're they've this those through to too under until up very was wasn't we
we'd we'll we're we've were weren't what what's when when's where where's
which while who who's whom why why's with won't would wouldn't you you'd
you'll you're you've your yours yourself yourselves
""".split())


# Rows of fitted text chains' fused prefix, by the path that hashed them:
# "native" for the C++ sweep (native/text.cpp), "python" for the rows it
# declined (non-ASCII), which the stages recompute.  Chains that do not
# take the fused path count nowhere here.
fused_rows = {"native": 0, "python": 0}


class Tokenizer(JaxTwin, Transformer):
    """Regex tokenizer (reference wraps Spark's RegexTokenizer,
    TextFeaturizer.scala:240-245: gaps/pattern/minTokenLength/toLowercase)."""

    inputCol = Param(None, "string column to tokenize", ptype=str, required=True)
    outputCol = Param("tokens", "token-list output column", ptype=str)
    pattern = Param(r"\s+", "regex: split pattern when gaps, match pattern "
                    "otherwise", ptype=str)
    gaps = Param(True, "pattern matches gaps (split) vs tokens (findall)",
                 ptype=bool)
    minTokenLength = Param(0, "drop tokens shorter than this", ptype=int)
    toLowercase = Param(True, "lowercase before tokenizing", ptype=bool)

    def transform(self, table: DataTable) -> DataTable:
        self._check_required()
        rx = re.compile(self.pattern)
        min_len = self.minTokenLength
        lower = self.toLowercase
        gaps = self.gaps

        def tok(text) -> list[str]:
            if text is None:
                return []
            s = str(text)
            if lower:
                s = s.lower()
            parts = rx.split(s) if gaps else rx.findall(s)
            return [t for t in parts if len(t) >= min_len and t]

        tokens = [tok(v) for v in table[self.inputCol]]
        return table.with_column(self.outputCol, _object_column(tokens))


class StopWordsRemover(JaxTwin, Transformer):
    """Filter stop words from token lists (reference TextFeaturizer.scala:246-253)."""

    inputCol = Param(None, "token-list column", ptype=str, required=True)
    outputCol = Param("filtered", "output column", ptype=str)
    stopWords = Param(None, "custom stop words (None = default English list)",
                      ptype=(list, tuple))
    caseSensitive = Param(False, "case-sensitive matching", ptype=bool)

    def transform(self, table: DataTable) -> DataTable:
        self._check_required()
        words = self.stopWords
        cs = self.caseSensitive
        stop = (set(words) if words is not None else set(ENGLISH_STOP_WORDS))
        if not cs:
            stop = {w.lower() for w in stop}
        out = [[t for t in toks if (t if cs else t.lower()) not in stop]
               for toks in table[self.inputCol]]
        return table.with_column(self.outputCol, _object_column(out))


class NGram(JaxTwin, Transformer):
    """Enumerate word n-grams (reference TextFeaturizer.scala:255-256)."""

    inputCol = Param(None, "token-list column", ptype=str, required=True)
    outputCol = Param("ngrams", "output column", ptype=str)
    n = Param(2, "gram size", ptype=int, validator=lambda v: v >= 1)

    def transform(self, table: DataTable) -> DataTable:
        self._check_required()
        n = self.n
        out = [[" ".join(toks[i:i + n]) for i in range(len(toks) - n + 1)]
               for toks in table[self.inputCol]]
        return table.with_column(self.outputCol, _object_column(out))


class HashingTF(JaxTwin, Transformer):
    """Hash token lists into term-count sparse rows
    (reference TextFeaturizer.scala:257-259; Spark default 2^18 slots)."""

    inputCol = Param(None, "token-list column", ptype=str, required=True)
    outputCol = Param("tf", "sparse term-count output column", ptype=str)
    numFeatures = Param(1 << 18, "hash space size", ptype=int,
                        validator=lambda v: v > 0)
    binary = Param(False, "binary presence instead of counts", ptype=bool)

    def transform(self, table: DataTable) -> DataTable:
        self._check_required()
        nf, binary = self.numFeatures, self.binary
        rows = hash_token_lists(list(table[self.inputCol]), nf, binary)
        out = table.with_column(self.outputCol, _object_column(rows))
        meta = out.meta(self.outputCol)
        meta.extra.update(num_features=nf, sparse=True)
        out.set_meta(self.outputCol, meta)
        return out


class IDFModel(JaxTwin, Transformer):
    """Apply fitted inverse-document-frequency weights to sparse rows."""

    inputCol = Param(None, "sparse term-count column", ptype=str, required=True)
    outputCol = Param("tfidf", "output column", ptype=str)

    def __init__(self, idf: Optional[dict[int, float]] = None,
                 default_weight: float = 0.0, **kwargs):
        super().__init__(**kwargs)
        self._idf = dict(idf or {})
        # weight for slots unseen at fit time: log(n+1) per the df=0 case of
        # Spark's formula when minDocFreq permits, else 0
        self._default = float(default_weight)

    def transform(self, table: DataTable) -> DataTable:
        self._check_required()
        col = table[self.inputCol]
        # one vectorized weight lookup over the concatenated corpus
        slots = np.fromiter(self._idf.keys(), np.int64, len(self._idf))
        order = np.argsort(slots)
        slots = slots[order]
        weights = np.fromiter(self._idf.values(), np.float32,
                              len(self._idf))[order]
        row_ids, indices, values = concat_sparse_rows(col)
        w = np.full(len(indices), self._default, np.float32)
        if len(slots) and len(indices):
            pos = np.searchsorted(slots, indices)
            ok = ((pos < len(slots))
                  & (slots[np.minimum(pos, len(slots) - 1)] == indices))
            w[ok] = weights[pos[ok]]
        weighted = values * w
        bounds = np.searchsorted(row_ids, np.arange(len(col) + 1))
        rows = [(col[i][0], weighted[bounds[i]:bounds[i + 1]])
                for i in range(len(col))]
        out = table.with_column(self.outputCol, _object_column(rows))
        meta = table.meta(self.inputCol).copy()
        out.set_meta(self.outputCol, meta)
        return out

    def _save_extra(self, path: str) -> None:
        import json, os
        with open(os.path.join(path, "idf.json"), "w") as f:
            json.dump({"weights": {str(k): v for k, v in self._idf.items()},
                       "default": self._default}, f)

    def _load_extra(self, path: str, **_init_kwargs) -> None:
        import json, os
        with open(os.path.join(path, "idf.json")) as f:
            d = json.load(f)
        self._idf = {int(k): float(v) for k, v in d["weights"].items()}
        self._default = float(d.get("default", 0.0))


class IDF(JaxTwin, Estimator):
    """Fit IDF weights: log((n+1)/(df+1)), Spark's formula, with minDocFreq
    zeroing rare terms (reference TextFeaturizer.scala:260-261)."""

    inputCol = Param(None, "sparse term-count column", ptype=str, required=True)
    outputCol = Param("tfidf", "output column", ptype=str)
    minDocFreq = Param(0, "terms in fewer docs get zero weight", ptype=int)

    def fit(self, table: DataTable) -> IDFModel:
        self._check_required()
        col = table[self.inputCol]
        # indices are unique within a row, so corpus-wide slot counts ARE
        # document frequencies — one np.unique over the concatenation
        _, indices, _ = concat_sparse_rows(col)
        slots, counts = np.unique(indices, return_counts=True)
        n = len(col)
        min_df = self.minDocFreq
        keep = counts >= min_df
        log_w = np.log((n + 1.0) / (counts[keep] + 1.0))
        idf = {int(s): float(v) for s, v in zip(slots[keep], log_w)}
        default = float(np.log(n + 1.0)) if min_df <= 0 else 0.0
        return IDFModel(idf, default_weight=default,
                        inputCol=self.inputCol, outputCol=self.outputCol)


class TextFeaturizerModel(JaxTwin, PipelineModel):
    """Fitted text chain; drops the intermediate token/tf columns
    (reference TextFeaturizerModel, TextFeaturizer.scala:350-367).

    When the chain's prefix is the default shape — Tokenizer(gaps, \\s+)
    [-> StopWordsRemover] -> HashingTF — scoring runs it as ONE fused C++
    sweep over the raw strings (native/text.cpp: no Python token objects
    materialized), byte-identical to the staged path; rows the kernel
    declines (non-ASCII: unicode tables stay in Python) and any remaining
    stages (IDF) run through the ordinary stage path; `fused_rows` counts
    the rows of each.  The stages remain
    the source of truth for params and persistence."""

    def __init__(self, stages=None, cols_to_drop: Optional[list] = None, **kw):
        super().__init__(stages, **kw)
        self._drop = list(cols_to_drop or [])

    def _fused_prefix(self):
        """(n_stages_fused, kwargs for native_text_hash) or None."""
        stages = self._stages
        if not stages or not isinstance(stages[0], Tokenizer):
            return None
        tok = stages[0]
        if not tok.gaps or tok.pattern != r"\s+":
            return None
        i, stop_words, case_sensitive = 1, [], False
        cur_col = tok.outputCol
        if i < len(stages) and isinstance(stages[i], StopWordsRemover):
            sw = stages[i]
            if sw.inputCol != cur_col:
                return None  # non-linear wiring: fusion would change results
            cur_col = sw.outputCol
            words = (list(sw.stopWords) if sw.stopWords is not None
                     else sorted(ENGLISH_STOP_WORDS))
            case_sensitive = sw.caseSensitive
            stop_words = words if case_sensitive else \
                [w.lower() for w in words]
            if any(ord(c) > 127 for w in stop_words for c in w):
                return None  # non-ASCII stop words: python path only
            i += 1
        if i >= len(stages) or not isinstance(stages[i], HashingTF):
            return None
        tf = stages[i]
        if tf.inputCol != cur_col:
            return None  # stage chain is not a straight line
        return i + 1, dict(
            stopwords=stop_words,
            lowercase=tok.toLowercase,
            # membership tests t.lower() when the remover is
            # case-insensitive but tokens were not already lowercased
            lower_for_stop=(not case_sensitive and not tok.toLowercase),
            min_token_len=tok.minTokenLength,
            num_features=tf.numFeatures,
            binary=tf.binary,
        ), tok.inputCol, tf.outputCol, tf

    def _transform_fused(self, table: DataTable):
        from mmlspark_tpu_torch.native_loader import native_text_hash
        spec = self._fused_prefix()
        if spec is None:
            return None
        n_fused, kwargs, in_col, tf_col, tf_stage = spec
        docs = list(table[in_col])
        result = native_text_hash(docs, **kwargs)
        if result is None:
            return None
        rows, fallback = result
        fused_rows["native"] += len(rows) - len(fallback)
        fused_rows["python"] += len(fallback)
        if fallback:
            # non-ASCII rows: exact recompute through the python stages
            sub = DataTable({in_col: _object_column(
                [docs[i] for i in fallback])})
            for st in self._stages[:n_fused]:
                sub = st.transform(sub)
            for j, i in enumerate(fallback):
                rows[i] = sub[tf_col][j]
        out = table.with_column(tf_col, _object_column(rows))
        meta = out.meta(tf_col)
        meta.extra.update(num_features=tf_stage.numFeatures, sparse=True)
        out.set_meta(tf_col, meta)
        for st in self._stages[n_fused:]:
            out = st.transform(out)
        return out

    def transform(self, table: DataTable) -> DataTable:
        clash = [c for c in self._drop if c in table]
        if clash:
            raise ValueError(
                f"input table already has columns {clash}, which this fitted "
                "model uses as intermediates; rename them before scoring")
        out = self._transform_fused(table)
        if out is None:
            out = super().transform(table)
        return out.drop(*[c for c in self._drop if c in out])

    def _save_extra(self, path: str) -> None:
        import json, os
        super()._save_extra(path)
        with open(os.path.join(path, "drop.json"), "w") as f:
            json.dump(self._drop, f)

    def _load_extra(self, path: str, **init_kwargs) -> None:
        import json, os
        super()._load_extra(path, **init_kwargs)
        with open(os.path.join(path, "drop.json")) as f:
            self._drop = json.load(f)


class TextFeaturizer(JaxTwin, Estimator):
    """Build and fit the configured text chain (reference fit at
    TextFeaturizer.scala:230-290: optional stages, then param rewiring —
    here the chain is assembled directly)."""

    inputCol = Param(None, "input text (or token-list) column", ptype=str,
                     required=True)
    outputCol = Param("features", "output column", ptype=str)
    useTokenizer = Param(True, "tokenize the input", ptype=bool)
    tokenizerGaps = Param(True, "regex matches gaps", ptype=bool)
    tokenizerPattern = Param(r"\s+", "tokenizer regex", ptype=str)
    minTokenLength = Param(0, "minimum token length", ptype=int)
    toLowercase = Param(True, "lowercase text", ptype=bool)
    useStopWordsRemover = Param(False, "remove stop words", ptype=bool)
    caseSensitiveStopWords = Param(False, "case sensitive stop words", ptype=bool)
    defaultStopWordLanguage = Param("english", "stop word language or 'custom'",
                                    ptype=str)
    stopWords = Param(None, "custom stop words, comma separated", ptype=str)
    useNGram = Param(False, "enumerate n-grams", ptype=bool)
    nGramLength = Param(2, "n-gram size", ptype=int)
    binary = Param(False, "binary term counts", ptype=bool)
    numFeatures = Param(1 << 18, "hash space size", ptype=int)
    useIDF = Param(True, "rescale by inverse document frequency", ptype=bool)
    minDocFreq = Param(1, "minimum document frequency for IDF", ptype=int)

    def fit(self, table: DataTable) -> TextFeaturizerModel:
        self._check_required()
        stages: list = []
        cur = self.inputCol
        drop: list[str] = []

        def next_col(suffix: str) -> str:
            name = table.find_unused_column_name(f"{self.outputCol}_{suffix}")
            drop.append(name)
            return name

        if self.useTokenizer:
            out = next_col("tok")
            stages.append(Tokenizer(
                inputCol=cur, outputCol=out, gaps=self.tokenizerGaps,
                pattern=self.tokenizerPattern,
                minTokenLength=self.minTokenLength,
                toLowercase=self.toLowercase))
            cur = out
        if self.useStopWordsRemover:
            out = next_col("sw")
            custom = ([w.strip() for w in self.stopWords.split(",") if w.strip()]
                      if self.defaultStopWordLanguage == "custom"
                      and self.stopWords else None)
            stages.append(StopWordsRemover(
                inputCol=cur, outputCol=out, stopWords=custom,
                caseSensitive=self.caseSensitiveStopWords))
            cur = out
        if self.useNGram:
            out = next_col("ng")
            stages.append(NGram(inputCol=cur, outputCol=out, n=self.nGramLength))
            cur = out
        tf_out = next_col("tf") if self.useIDF else self.outputCol
        stages.append(HashingTF(inputCol=cur, outputCol=tf_out,
                                numFeatures=self.numFeatures,
                                binary=self.binary))
        fitted: list[Transformer] = []
        current = table
        for st in stages:
            current = st.transform(current)
            fitted.append(st)
        if self.useIDF:
            idf = IDF(inputCol=tf_out, outputCol=self.outputCol,
                      minDocFreq=self.minDocFreq).fit(current)
            fitted.append(idf)
        return TextFeaturizerModel(fitted, cols_to_drop=drop)

"""Hot-word biasing: post-ASR correction toward the user's vocabulary.

Semantics ported from the reference's pure-Rust post-processor that runs on
every successful local transcription (``qwen_hotword_service.rs:32-510``):

- **Han candidates**: same-length windows of Han characters whose toneless
  pinyin signature equals the hot word's, with a shared-character floor
  (manual words: len/3, learned: ceil(len/2)); score 900 + 20·shared + 5·len.
- **ASCII candidates**: word-span windows of ±1 word count whose normalized
  (lowercase alphanumeric) form matches at Levenshtein 0 (any hot word with
  canonical styling — ≥2 uppercase — or manual), or ≤1-2 edits for manual
  words of length ≥5 (2 edits from length 10), skipping simple inflections
  (s/es/ed/ing); scores 1000+len / 800+len−50·distance.
- Overlaps resolved by score → span length → rank → position; replacements
  applied right-to-left. Cap: 100 hot words.

The port's copy of ``light_whisper_tpu/text/hotwords.py`` as the engine
server calls it (``HotWordCorrector``): protocol hot words carry no learned
correction patterns, so the reference's alias-replay pass has nothing to
replay there and is not copied.

All indices are byte offsets into the UTF-8 encoding (the Rust code operates
on byte indices); the public API works on ``str`` and handles the encoding
internally.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Iterable, List, Optional, Sequence, Tuple

from light_whisper_tpu_torch.text.pinyin import pinyin_signature, pinyin_table

MAX_ASR_HOT_WORDS = 100


class Source(enum.Enum):
    USER = "user"
    AI = "ai"
    LEARNED = "learned"


@dataclasses.dataclass
class HotWord:
    text: str
    weight: int = 1
    use_count: int = 0
    source: Source = Source.USER


@dataclasses.dataclass
class CorrectionResult:
    text: str
    replacements: int


@dataclasses.dataclass
class _Candidate:
    start: int  # char index
    end: int
    replacement: str
    score: int
    rank: int


def is_han(ch: str) -> bool:
    cp = ord(ch)
    return (
        0x3400 <= cp <= 0x4DBF
        or 0x4E00 <= cp <= 0x9FFF
        or 0xF900 <= cp <= 0xFAFF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0x2CEB0 <= cp <= 0x2EBEF
        or 0x30000 <= cp <= 0x3134F
    )


def _levenshtein_py(left: str, right: str) -> int:
    previous = list(range(len(right) + 1))
    current = [0] * (len(right) + 1)
    for i, lc in enumerate(left):
        current[0] = i + 1
        for j, rc in enumerate(right):
            cost = previous[j] + (lc != rc)
            current[j + 1] = min(previous[j + 1] + 1, current[j] + 1, cost)
        previous, current = current, previous
    return previous[len(right)]


try:  # native edit distance (the p95<1ms contract needs it on slow hosts)
    from Levenshtein import distance as levenshtein  # type: ignore
except ImportError:  # pragma: no cover
    levenshtein = _levenshtein_py


def _ascii_word_spans(text: str) -> Tuple[Tuple[int, int], ...]:
    """Spans of ASCII-alnum runs; memoized only for short texts.

    The repeating keys are hot-word/correction terms (tiny, hit every
    tick). Transcripts are also routed through here but every interim tick
    produces a NEW transcript string — caching those retains up to 4096
    arbitrarily large texts (a 33-min transcript is ~600 KB of spans) for
    process lifetime with a near-zero hit rate, so long texts bypass the
    cache.
    """
    if len(text) <= 256:
        return _ascii_word_spans_cached(text)
    return _ascii_word_spans_impl(text)


@functools.lru_cache(maxsize=4096)
def _ascii_word_spans_cached(text: str) -> Tuple[Tuple[int, int], ...]:
    return _ascii_word_spans_impl(text)


def _ascii_word_spans_impl(text: str) -> Tuple[Tuple[int, int], ...]:
    spans = []
    start: Optional[int] = None
    for index, ch in enumerate(text):
        if ch.isascii() and ch.isalnum():
            if start is None:
                start = index
        elif start is not None:
            spans.append((start, index))
            start = None
    if start is not None:
        spans.append((start, len(text)))
    return tuple(spans)


@functools.lru_cache(maxsize=4096)
def _normalize_ascii(text: str) -> str:
    return "".join(ch.lower() for ch in text if ch.isascii() and ch.isalnum())


def _has_canonical_ascii_style(text: str) -> bool:
    return sum(1 for ch in text if ch.isascii() and ch.isupper()) >= 2


def _is_simple_inflection(candidate: str, hot: str) -> bool:
    for suffix in ("s", "es", "ed", "ing"):
        if candidate == hot + suffix or hot == candidate + suffix:
            return True
    return False


def _ranked_hot_words(hot_words: Sequence[HotWord]) -> List[HotWord]:
    ranked = sorted(hot_words, key=lambda h: (-h.weight, -h.use_count))
    return ranked[:MAX_ASR_HOT_WORDS]


def _select_and_apply(text: str, candidates: List[_Candidate]) -> CorrectionResult:
    candidates.sort(key=lambda c: (-c.score, -(c.end - c.start), c.rank, c.start))
    selected: List[_Candidate] = []
    for cand in candidates:
        if not any(cand.start < kept.end and kept.start < cand.end for kept in selected):
            selected.append(cand)
    selected.sort(key=lambda c: -c.start)
    corrected = text
    for cand in selected:
        corrected = corrected[: cand.start] + cand.replacement + corrected[cand.end :]
    return CorrectionResult(text=corrected, replacements=len(selected))


# ---------------------------------------------------------------------------
# hot-word pass
# ---------------------------------------------------------------------------


class _HanIndex:
    """Per-text pinyin readings, shared across hot words.

    The Han pass used to recompute ``pinyin_signature`` for every window of
    every hot word — the same O(words × windows) shape that blew the <1 ms
    p95 contract on the ASCII side (see :class:`_AsciiWindowIndex`). One
    pass over the text caches each char's reading and Han-ness; a window's
    signature is then a plain slice."""

    def __init__(self, text: str) -> None:
        table = pinyin_table()
        self.readings: List[Optional[str]] = [
            table.get(ch) if is_han(ch) else None for ch in text
        ]
        # prefix counts of Han chars for O(1) all-Han window checks
        self._han_prefix = [0]
        acc = 0
        for ch in text:
            acc += 1 if is_han(ch) else 0
            self._han_prefix.append(acc)

    def all_han(self, start: int, end: int) -> bool:
        return self._han_prefix[end] - self._han_prefix[start] == end - start

    def signature(self, start: int, end: int) -> Optional[List[str]]:
        sig = self.readings[start:end]
        return None if any(r is None for r in sig) else sig  # type: ignore[return-value]


def _collect_han(
    text: str,
    index: _HanIndex,
    hot_word: HotWord,
    hot_text: str,
    rank: int,
    out: List[_Candidate],
):
    hot_chars = list(hot_text)
    hot_len = len(hot_chars)
    is_manual = hot_word.source == Source.USER and hot_word.weight >= 3
    min_len = 2 if is_manual else 3
    if hot_len < min_len or hot_len > len(text):
        return
    hot_py = pinyin_signature(hot_chars)
    if hot_py is None:
        return
    min_shared = max(1, hot_len // 3) if is_manual else max(1, -(-hot_len // 2))

    for start in range(len(text) - hot_len + 1):
        end = start + hot_len
        if not index.all_han(start, end):
            continue
        window = text[start:end]
        if window == hot_text:
            continue
        shared = sum(1 for a, b in zip(window, hot_chars) if a == b)
        if shared < min_shared:
            continue
        cand_py = index.signature(start, end)
        if cand_py is None or cand_py != hot_py:
            continue
        out.append(
            _Candidate(
                start=start,
                end=end,
                replacement=hot_text,
                score=900 + shared * 20 + hot_len * 5,
                rank=rank,
            )
        )


class _AsciiWindowIndex:
    """Per-text cache of ASCII candidate windows, shared across hot words.

    The windows (word-span runs of 1..N words, their raw text and normalized
    form) depend only on the input text — recomputing them per hot word made
    the pass O(words × windows) string builds, the dominant cost at the
    reference's 100-hot-word cap (p95 crept to ~16 ms/tick on CI hosts vs
    the <1 ms Rust contract, ``qwen_hotword_service.rs:780-798``). Windows
    are built lazily per word-count and bucketed by normalized length so a
    hot word only Levenshteins against length-compatible candidates (edit
    distance is bounded below by the length gap)."""

    def __init__(self, text: str, words: List[Tuple[int, int]]) -> None:
        self.text = text
        self.words = words
        # span chars are ascii alnum by construction: norm == lowercase concat
        self._word_norms = [text[s:e].lower() for s, e in words]
        self._by_count: dict = {}

    def _windows(self, word_count: int) -> dict:
        """dict: norm length → [(start, end, raw, norm)] for this count."""
        cached = self._by_count.get(word_count)
        if cached is None:
            cached = {}
            text, words, norms = self.text, self.words, self._word_norms
            for i in range(len(words) - word_count + 1):
                start = words[i][0]
                end = words[i + word_count - 1][1]
                raw = text[start:end]
                if not raw.isascii():
                    continue
                norm = "".join(norms[i : i + word_count])
                cached.setdefault(len(norm), []).append((start, end, raw, norm))
            self._by_count[word_count] = cached
        return cached

    def near_length(self, word_count: int, length: int, slack: int):
        by_len = self._windows(word_count)
        for cand_len in range(max(1, length - slack), length + slack + 1):
            yield from by_len.get(cand_len, ())


def _collect_ascii(
    text: str,
    windows: _AsciiWindowIndex,
    hot_word: HotWord,
    hot_text: str,
    rank: int,
    out: List[_Candidate],
):
    hot_norm = _normalize_ascii(hot_text)
    if not hot_norm:
        return
    hot_word_count = max(1, len(_ascii_word_spans(hot_text)))
    min_words = max(1, hot_word_count - 1)
    max_words = hot_word_count + 1
    is_manual = hot_word.source == Source.USER and hot_word.weight >= 3
    if not is_manual and not _has_canonical_ascii_style(hot_text):
        return

    for word_count in range(min_words, max_words + 1):
        # cheap pre-filter: edits are bounded below by the length gap
        for start, end, raw, cand_norm in windows.near_length(
            word_count, len(hot_norm), 2
        ):
            if raw == hot_text:
                continue
            distance = levenshtein(cand_norm, hot_norm)
            if distance == 0:
                out.append(
                    _Candidate(start, end, hot_text, 1000 + len(hot_norm), rank)
                )
                continue
            if not is_manual or len(hot_norm) < 5:
                continue
            max_distance = 2 if len(hot_norm) >= 10 else 1
            if distance > max_distance or abs(len(cand_norm) - len(hot_norm)) > max_distance:
                continue
            if _is_simple_inflection(cand_norm, hot_norm):
                continue
            out.append(
                _Candidate(start, end, hot_text, 800 + len(hot_norm) - distance * 50, rank)
            )


def correct_hot_words(text: str, hot_words: Sequence[HotWord]) -> CorrectionResult:
    if not text or not hot_words:
        return CorrectionResult(text=text, replacements=0)

    windows = _AsciiWindowIndex(text, _ascii_word_spans(text))
    han_index = _HanIndex(text)
    candidates: List[_Candidate] = []
    for rank, hot_word in enumerate(_ranked_hot_words(hot_words)):
        hot_text = hot_word.text.strip()
        if not hot_text or hot_text in text:
            continue
        if all(is_han(ch) for ch in hot_text):
            _collect_han(text, han_index, hot_word, hot_text, rank, candidates)
        elif hot_text.isascii() and any(ch.isalnum() for ch in hot_text):
            _collect_ascii(text, windows, hot_word, hot_text, rank, candidates)
    return _select_and_apply(text, candidates)


class HotWordCorrector:
    """Engine-facing adapter: plain hot-word strings from the protocol.

    Protocol hot words carry no weight/source metadata, so they are treated
    as manual user entries (weight 3) — the strongest matching tier.
    """

    def correct(self, text: str, hot_words: Iterable[str]) -> str:
        entries = [
            HotWord(text=w, weight=3, source=Source.USER) for w in hot_words if w and w.strip()
        ]
        return correct_hot_words(text, entries).text

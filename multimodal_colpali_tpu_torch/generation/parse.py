"""LLM answer parsing with permutation recovery (a copy of
``multimodal_colpali_tpu/generation/parse.py``).

Behavior parity with reference ``response_real_out`` (functions.py:1721-1763):
three-stage letter extraction (exact match / JSON + regex / cleanup + regex),
then de-permutation through the per-question answer order ``perm_q`` to
recover the true answer letter.

Behavioral deviations (intentional fixes, per the repo's parity convention):

- The stage-2/3 regexes add a ``$`` alternative after the letter, so a bare
  trailing letter ("The answer is: B") parses. The reference's
  ``(A|B|C|D)(\\s|.)`` requires a character AFTER the letter and returns ""
  for such responses (functions.py:1739,1752), silently scoring them wrong.
- Stage 2 additionally accepts ``{"answer": "X"}`` dicts (the structured
  output the clients actually produce) and returns from stage 2 instead of
  falling through; the reference only handles JSON-encoded strings.
"""

from __future__ import annotations

import json
import re
from typing import List, Sequence, Tuple

ANS_LIST = ["A", "B", "C", "D"]


def _depermute(letter: str, perm_q: Sequence[int]) -> str:
    """perm_q[i] = original answer index shown at position i. The model
    answered position ``letter``; the true letter is the original index."""
    pos = ANS_LIST.index(letter)
    return ANS_LIST[perm_q[pos]]


def response_real_out(response, perm_q: Sequence[int]) -> Tuple[str, str]:
    """-> (model_letter, true_letter); ("", "") when unparseable."""
    if response is None:
        return "", ""
    if response in ANS_LIST:
        return response, _depermute(response, perm_q)
    # Stage 2: JSON payload that decodes to a string starting with a letter,
    # or a {"answer": "X"} structured output.
    try:
        tmp = json.loads(response)
        if isinstance(tmp, dict):
            tmp = str(tmp.get("answer", ""))
        if isinstance(tmp, str):
            match = re.search(r"^\s*(A|B|C|D)(\s|.|$)", tmp)
            if match and match.group(1) in ANS_LIST:
                resp = match.group(1)
                return resp, _depermute(resp, perm_q)
            return "", ""
    except (json.JSONDecodeError, TypeError, ValueError):
        pass
    # Stage 3: cleanup - collapse whitespace, take text after the last colon,
    # uppercase, and find the first letter mention.
    try:
        tt = " ".join(str(response).split())
        tt = tt.split(":")[-1][:10]
        tt = tt.upper()[:20]
        match = re.search(r"(A|B|C|D)(\s|.|$)", tt)
        if match and match.group(1) in ANS_LIST:
            resp = match.group(1)
            return resp, _depermute(resp, perm_q)
        return "", ""
    except Exception:
        return "", ""


def identity_perm() -> List[int]:
    return [0, 1, 2, 3]

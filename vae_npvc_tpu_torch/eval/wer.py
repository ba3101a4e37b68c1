"""CER/WER scoring with sclite semantics.

The reference scores ASR transcripts of converted speech with NIST sclite via
ESPnet's ``score_sclite_wo_dict.sh`` (reference:
egs/vcc20/vae1/local/ob_eval/evaluate.sh:155) and greps the ``Sum/Avg`` error
column from ``result.txt`` (char level) / ``result.wrd.txt`` (word level)
(reference: egs/vcc20/vae1/test.sh:19-20). sclite is an external C tool; this
module reimplements its scoring semantics in-framework:

- dynamic-programming alignment per utterance with sclite's operation
  preference (substitution cheaper than insertion+deletion);
- per-utterance counts of Corr/Sub/Del/Ins;
- an aggregate ``Sum/Avg`` row where ``Err% = (S+D+I)/N*100`` over the total
  reference token count and ``S.Err%`` is the sentence error rate;
- word level tokenizes on whitespace; char level scores the
  whitespace-stripped character sequence (ESPnet CER convention).

``write_report`` emits a result.txt-shaped table so downstream greps keep
working.

The port's own copy of ``vae_npvc_tpu/eval/wer.py`` (host numpy; the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence, Tuple

# sclite's default alignment weights (word-to-word): sub 4, ins 3, del 3.
_SUB, _INS, _DEL = 4, 3, 3


@dataclass
class Counts:
    corr: int = 0
    sub: int = 0
    dele: int = 0
    ins: int = 0

    @property
    def n_ref(self) -> int:
        return self.corr + self.sub + self.dele

    @property
    def n_err(self) -> int:
        return self.sub + self.dele + self.ins

    @property
    def err_pct(self) -> float:
        return 100.0 * self.n_err / max(self.n_ref, 1)

    def __iadd__(self, other: "Counts") -> "Counts":
        self.corr += other.corr
        self.sub += other.sub
        self.dele += other.dele
        self.ins += other.ins
        return self


def align(ref: Sequence[str], hyp: Sequence[str]) -> Counts:
    """Minimum-cost alignment of hyp against ref with sclite weights."""
    R, H = len(ref), len(hyp)
    # dp[i][j] = cost of aligning ref[:i] with hyp[:j]
    prev = [j * _INS for j in range(H + 1)]
    # op[i][j]: 0 match, 1 sub, 2 del, 3 ins (for backtrace counting)
    ops: List[List[int]] = [[3] * (H + 1)]
    ops[0][0] = 0
    for i in range(1, R + 1):
        cur = [i * _DEL] + [0] * H
        op_row = [2] + [0] * H
        ri = ref[i - 1]
        for j in range(1, H + 1):
            if ri == hyp[j - 1]:
                best, bop = prev[j - 1], 0
            else:
                best, bop = prev[j - 1] + _SUB, 1
            d = prev[j] + _DEL
            if d < best:
                best, bop = d, 2
            ins = cur[j - 1] + _INS
            if ins < best:
                best, bop = ins, 3
            cur[j], op_row[j] = best, bop
        prev = cur
        ops.append(op_row)

    c = Counts()
    i, j = R, H
    while i > 0 or j > 0:
        op = ops[i][j]
        if op == 0 and i > 0 and j > 0:
            c.corr += 1
            i, j = i - 1, j - 1
        elif op == 1:
            c.sub += 1
            i, j = i - 1, j - 1
        elif op == 2:
            c.dele += 1
            i -= 1
        else:
            c.ins += 1
            j -= 1
    return c


def tokenize(text: str, level: str) -> List[str]:
    if level == "word":
        return text.split()
    if level == "char":
        return list(text.replace(" ", ""))
    raise ValueError(f"unknown level {level!r}")


def score(refs: Mapping[str, str], hyps: Mapping[str, str],
          level: str = "word") -> Tuple[Counts, int, Dict[str, Counts]]:
    """Score hyps against refs.

    Returns (total counts, sentence-error count, per-utt counts). Utterances
    present in refs but missing from hyps count as all-deletions (sclite
    treats a missing hypothesis as an empty string).
    """
    total = Counts()
    s_err = 0
    per_utt: Dict[str, Counts] = {}
    for utt in sorted(refs):
        c = align(tokenize(refs[utt], level),
                  tokenize(hyps.get(utt, ""), level))
        per_utt[utt] = c
        total += c
        if c.n_err:
            s_err += 1
    return total, s_err, per_utt


def write_report(path, refs: Mapping[str, str], hyps: Mapping[str, str],
                 level: str = "word") -> Counts:
    """Write a result.txt-shaped report; returns the aggregate counts.

    The ``Sum/Avg`` row has the sclite column order
    ``#Snt #Wrd | Corr Sub Del Ins Err S.Err`` so the reference's
    ``awk '{print $11}'`` Err% extraction keeps working
    (reference: egs/vcc20/vae1/test.sh:19-20).
    """
    total, s_err, per_utt = score(refs, hyps, level)
    n_snt = len(per_utt)
    with open(path, "w") as f:
        f.write(f"REPORT {level}-level (in-framework sclite-semantics "
                "scorer)\n")
        f.write("id | #Ref C S D I Err%\n")
        f.write("-" * 60 + "\n")
        for utt, c in per_utt.items():
            f.write(f"{utt} | {c.n_ref} {c.corr} {c.sub} {c.dele} {c.ins} "
                    f"{c.err_pct:.1f}\n")
        f.write("-" * 60 + "\n")
        corr_pct = 100.0 * total.corr / max(total.n_ref, 1)
        sub_pct = 100.0 * total.sub / max(total.n_ref, 1)
        del_pct = 100.0 * total.dele / max(total.n_ref, 1)
        ins_pct = 100.0 * total.ins / max(total.n_ref, 1)
        serr_pct = 100.0 * s_err / max(n_snt, 1)
        f.write(f"| Sum/Avg | {n_snt} {total.n_ref} | {corr_pct:.1f} "
                f"{sub_pct:.1f} {del_pct:.1f} {ins_pct:.1f} "
                f"{total.err_pct:.1f} {serr_pct:.1f} |\n")
    return total

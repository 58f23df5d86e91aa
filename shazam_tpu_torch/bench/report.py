"""Benchmark report artifacts with the reference's exact schema.

The port of ``shazam_tpu/bench/report.py``, which reproduces
``generate_csv_results`` (reference ``recognizer_test.py:437-513``):

- a per-trial CSV with columns file_name_played, file_name_result,
  song_start_time, correct, fingerprint_times, query_time, align_time,
  total_time, final_results;
- the hand-rolled pandas crosstab confusion matrix (``CM_`` prefix);
- sklearn confusion_matrix / classification_report / accuracy_score dumps
  (``CMSK_`` / ``CRSK_`` / ``ASSK_`` prefixes);
- the same file-naming scheme encoding date, record count, clip seconds,
  SNR and checkpoint position (``recognizer_test.py:479-481``).

The JAX package writes the last four files through pandas and
scikit-learn; this module computes them with ``csv`` and numpy alone (the
card's machine need not have either library) and writes the same bytes:
pandas' CSV layout (``\\n`` line ends, float64 as its shortest repr) and
sklearn's label order, ``zero_division=0`` and averaging arithmetic
(tests hold the files byte-equal to the JAX package's).
"""

from __future__ import annotations

import csv
import datetime
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

CSV_COLUMNS = [
    "file_name_played", "file_name_result", "song_start_time", "correct",
    "fingerprint_times", "query_time", "align_time", "total_time",
    "final_results",
]


def _csv_name(n_records: int, record_seconds: float, snr: Optional[float],
              iteration: int, now: Optional[datetime.datetime] = None) -> str:
    stamp = (now or datetime.datetime.now()).strftime("%d-%m-%Y_%H-%M-%S")
    base = f"shazam_results_{stamp}_{n_records}records_{record_seconds:g}seconds"
    if snr is not None:
        base += f"_{snr:g}SNR"
    return f"{base}_atSong{iteration + 1}.csv"


def _write_table(path: str, rows: List[List]) -> None:
    """Rows as pandas' ``to_csv`` writes them: minimal quoting, ``\\n``."""
    with open(path, "w", newline="") as fh:
        csv.writer(fh, lineterminator="\n").writerows(rows)


def _float(x) -> str:
    """A float64 cell as pandas writes it (the shortest repr)."""
    return repr(float(x))


def _crosstab_cm(true_names: List[str], predicted: List[str]) -> List[List]:
    """The reference's hand-rolled confusion matrix
    (``recognizer_test.py:492-500``): ``pd.crosstab(y_true, y_true)``,
    then per mispredicted trial its diagonal cell zeroed and its
    (actual, predicted) cell set to 1, a predicted name never played
    appended as a column of zeros first."""
    labels = sorted(set(true_names))
    cols = list(labels)
    cells = {(t, t): 0 for t in labels}
    for t in true_names:
        cells[t, t] += 1
    for t, p in zip(true_names, predicted):
        if t != p:
            cells[t, t] = 0
            if p not in cols:
                cols.append(p)
            cells[t, p] = 1
    return ([["Actual", *cols]]
            + [[r, *(cells.get((r, c), 0) for c in cols)] for r in labels])


def _classification_report(true_names: List[str], predicted: List[str]):
    """sklearn's ``confusion_matrix``, ``classification_report(
    output_dict=True, zero_division=0)`` and ``accuracy_score`` over the
    sorted union of the names: (cm, report rows, accuracy)."""
    labels = sorted(set(true_names) | set(predicted))
    at = {name: i for i, name in enumerate(labels)}
    cm = np.zeros((len(labels), len(labels)), np.int64)
    for t, p in zip(true_names, predicted):
        cm[at[t], at[p]] += 1
    tp = np.diag(cm)
    pred_sum = cm.sum(axis=0)
    true_sum = cm.sum(axis=1)

    def divide(num, den):
        den = den.astype(np.float64)
        zero = den == 0
        den[zero] = 1.0
        out = np.asarray(num, np.float64) / den
        out[zero] = 0.0
        return out

    precision = divide(tp, pred_sum)
    recall = divide(tp, true_sum)
    f1 = divide(2.0 * tp.astype(np.float64),
                1.0 * true_sum.astype(np.float64) + pred_sum)
    support = float(np.sum(true_sum))
    rows = [[name, precision[i], recall[i], f1[i], float(true_sum[i])]
            for i, name in enumerate(labels)]
    acc = float(divide(np.array([tp.sum()]), np.array([pred_sum.sum()]))[0])
    rows.append(["accuracy", acc, acc, acc, acc])
    rows.append(["macro avg", np.nanmean(precision), np.nanmean(recall),
                 np.nanmean(f1), support])
    rows.append(["weighted avg",
                 *(np.average(v, weights=true_sum)
                   for v in (precision, recall, f1)), support])
    return cm, rows, acc


def generate_csv_results(
    songs_played: Sequence[str],
    predicted_names: Sequence[str],
    trial_times: Sequence[Dict],
    final_results_strs: Sequence[str],
    iteration: int,
    out_dir: str = ".",
    record_seconds: float = 5.0,
    snr: Optional[float] = None,
    now: Optional[datetime.datetime] = None,
) -> Dict[str, str]:
    """Write the five artifact files; returns {kind: path} plus
    ``"accuracy"``, the accuracy as a string.

    Ground truth is by filename, exactly like the reference
    (``recognizer_test.py:456``): predicted name string-compared to the
    played file's extensionless basename.
    """
    os.makedirs(out_dir, exist_ok=True)
    true_names = [
        os.path.splitext(os.path.basename(p))[0] for p in songs_played
    ]
    predicted = [str(p) for p in predicted_names]

    rows = []
    for i, played in enumerate(songs_played):
        rows.append({
            "file_name_played": str(played),
            "file_name_result": str(predicted_names[i]),
            "song_start_time": trial_times[i]["song_start_time"],
            "correct": 1 if true_names[i] == predicted_names[i] else 0,
            "fingerprint_times": trial_times[i]["fingerprint_times"],
            "query_time": trial_times[i]["query_time"],
            "align_time": trial_times[i]["align_time"],
            "total_time": trial_times[i]["total_time"],
            "final_results": final_results_strs[i],
        })

    name = _csv_name(len(songs_played), record_seconds, snr, iteration, now)
    paths = {"results": os.path.join(out_dir, name)}
    with open(paths["results"], "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=CSV_COLUMNS)
        writer.writeheader()
        writer.writerows(rows)

    paths["cm"] = os.path.join(out_dir, "CM_" + name)
    _write_table(paths["cm"], _crosstab_cm(true_names, predicted))

    cm, report, acc = _classification_report(true_names, predicted)
    paths["cmsk"] = os.path.join(out_dir, "CMSK_" + name)
    _write_table(paths["cmsk"],
                 [["", *range(len(cm))]]
                 + [[i, *row.tolist()] for i, row in enumerate(cm)])
    paths["crsk"] = os.path.join(out_dir, "CRSK_" + name)
    _write_table(paths["crsk"],
                 [["", "precision", "recall", "f1-score", "support"]]
                 + [[r[0], *map(_float, r[1:])] for r in report])
    paths["assk"] = os.path.join(out_dir, "ASSK_" + name)
    _write_table(paths["assk"], [["", 0], [0, _float(acc)]])
    paths["accuracy"] = str(acc)
    return paths

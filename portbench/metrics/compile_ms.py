"""compile_ms: host ms of the tape compiler in set-up
(tape/tape.py::compile_tree of the scene, the native compiler loaded or
built at its first use); moves setup_s."""


def read(t):
    return None if t.compile_s is None else 1e3 * t.compile_s

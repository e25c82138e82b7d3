"""imports_s.setup: seconds from the process's start to the end of its
imports (Python, torch with its CUDA libraries, the harness and the cell's
driver), the first phase of ``setup_s``; moves setup_s."""


def read(record):
    if not record or "imports" not in record.get("phases", {}):
        return None
    return record["phases"]["imports"]

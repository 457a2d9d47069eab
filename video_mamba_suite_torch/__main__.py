"""``python -m video_mamba_suite_torch <task> ...``: the task CLI
(``cli.py``)."""

from .cli import main

if __name__ == "__main__":
    main()

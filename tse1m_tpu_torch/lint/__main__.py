"""``python -m tse1m_tpu_torch.lint`` — run graftlint over the port."""

import sys

from .engine import main

if __name__ == "__main__":
    sys.exit(main())

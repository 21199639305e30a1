"""``generate_report``: the report stage's command line
(``rankaae_tpu_torch/report/generate_report.py`` says what it writes)."""
from rankaae_tpu_torch.report.generate_report import main

if __name__ == "__main__":
    main()

"""CT802 negative: every declared flag is read — directly, via literal
getattr, via an f-string getattr pattern, or named in a key list — and
programmatic ``args.x = ...`` stores count as declarations."""
import argparse

TASKS = ("glue", "squad")


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--log-steps", type=int)
    parser.add_argument("--seed", type=int)
    parser.add_argument("--glue-checkpoint")
    parser.add_argument("--squad-checkpoint")
    parser.add_argument("--resume-step", type=int)
    return parser


def require_args(names):
    return names


def main():
    args = build_parser().parse_args()
    seed = getattr(args, "seed", 0)
    for task in TASKS:
        print(getattr(args, f"{task}_checkpoint"))
    require_args(["resume_step"])
    args.derived_total = args.log_steps * seed
    return args.derived_total

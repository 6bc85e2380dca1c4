"""CT802 positive: a flag declared but never read anywhere, and a
namespace attribute read but never declared."""
import argparse


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--log-steps", type=int, default=10)
    parser.add_argument("--dead-knob", type=float, default=0.5)
    return parser


def main():
    args = build_parser().parse_args()
    print(args.log_steps, args.warmup_steps)

"""QA inspection tools — the reference's 3e-show/review script family.

Non-interactive equivalents (this environment is headless; the reference
pops cv2 windows): each subcommand writes annotated PNGs or prints reports.

- ``features <image>``   — draw detected keypoints (3e-show-features.py)
- ``pair <img1> <img2>`` — side-by-side match visualization with inlier
                           lines (3e-show-match-pairs.py / find_obj.py)
- ``groups``             — group membership/connectivity report
                           (3e-show-image-groups.py)
- ``matches``            — chain-length histogram + per-image match counts
                           (3e-review-matches.py flavor)
- ``review``             — keyboard triage of pairs or images (d/q keys;
                           ``--keys`` scripts it headless)

Port of ``imageanalysis_tpu/apps/inspect.py``. The drawing is host cv2,
the same code; the by-image review's reprojection errors come from
``apps/cull.compute_errors`` on the device. Usage: ``python -m
imageanalysis_tpu_torch.apps.inspect <subcommand> <project> ...``; it runs
on the CUDA card, ``IMGTPU_PLATFORM=cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..core.device import checked
from ..io.logger import log
from .process import main_device


def _proj(path):
    from ..io.project import ProjectMgr

    p = ProjectMgr(path)
    p.load_images_info()
    return p


def cmd_features(args):
    import cv2

    proj = _proj(args.project)
    im = proj.image_by_name(args.image)
    if im is None:
        log("unknown image:", args.image)
        return 1
    im.load_features()
    img = cv2.imread(proj.image_path(im))
    for (x, y), (size, *_), in zip(im.kp, im.kp_meta):
        cv2.circle(img, (int(x), int(y)), max(int(size / 2), 2),
                   (0, 255, 0), 1)
    out = args.out or f"{args.image}-features.png"
    cv2.imwrite(out, img)
    log(f"{len(im.kp)} features → {out}")
    return 0


def cmd_pair(args):
    import cv2

    proj = _proj(args.project)
    i1 = proj.image_by_name(args.image1)
    i2 = proj.image_by_name(args.image2)
    i1.load_features()
    i2.load_features()
    i1.load_matches()
    pairs = i1.match_list.get(i2.name, [])
    img1 = cv2.imread(proj.image_path(i1))
    img2 = cv2.imread(proj.image_path(i2))
    h = max(img1.shape[0], img2.shape[0])
    canvas = np.zeros((h, img1.shape[1] + img2.shape[1], 3), np.uint8)
    canvas[:img1.shape[0], :img1.shape[1]] = img1
    canvas[:img2.shape[0], img1.shape[1]:] = img2
    off = img1.shape[1]
    for a, b in pairs[:: max(len(pairs) // 200, 1)]:
        p1 = tuple(int(v) for v in i1.kp[a])
        p2 = (int(i2.kp[b][0]) + off, int(i2.kp[b][1]))
        cv2.line(canvas, p1, p2, (0, 255, 0), 1)
        cv2.circle(canvas, p1, 3, (0, 0, 255), -1)
        cv2.circle(canvas, p2, 3, (0, 0, 255), -1)
    out = args.out or f"{args.image1}-vs-{args.image2}.png"
    cv2.imwrite(out, canvas)
    log(f"{len(pairs)} matches → {out}")
    return 0


def cmd_groups(args):
    from ..match import groups as groups_mod

    proj = _proj(args.project)
    grps = groups_mod.load(proj.analysis_dir)
    if not grps:
        log("no groups.json")
        return 1
    placed = set()
    for gi, g in enumerate(grps):
        log(f"group {gi}: {len(g)} images")
        for name in g:
            log("  ", name)
        placed.update(g)
    missing = [im.name for im in proj.image_list if im.name not in placed]
    if missing:
        log(f"unplaced images ({len(missing)}):", ", ".join(missing))
    return 0


def cmd_matches(args):
    proj = _proj(args.project)
    matches = proj.load_matches_grouped()
    lens = np.array([len(m) - 2 for m in matches])
    log(f"{len(matches)} chains, {lens.sum()} observations")
    for k in range(2, min(lens.max() + 1, 12)):
        log(f"  chains of length {k}: {(lens == k).sum()}")
    counts = {}
    for m in matches:
        for img, _ in m[2:]:
            counts[img] = counts.get(img, 0) + 1
    log("per-image observation counts:")
    for img in sorted(counts):
        log(f"  {proj.image_list[img].name}: {counts[img]}")
    return 0


class ReviewSession:
    """Keyboard match-triage state machine — the reference's interactive
    review loops (3e-review-matches.py:1-343 pair d/q flow; 4b-mre-by-image
    --interactive, 4b:117-198) with the UI separated from the decisions so
    headless tests can drive the same logic with injected key sequences.

    mode='pairs': items are image pairs ordered weakest-first (ascending
    match count — review the suspect pairs first, like the reference's
    ordering); 'd' discards the pair's matches. mode='images': items are
    images ordered worst-mean-reprojection-first; 'd' discards every match
    of that image. Any other key advances; 'q' ends the session. Decisions
    apply to the .match files only on save(). The by-image errors are
    projected on device."""

    def __init__(self, proj, mode="pairs", device="cuda"):
        self.proj = proj
        self.mode = mode
        self.idx = 0
        self.dropped = []
        self.done = False
        name_idx = {im.name: im for im in proj.image_list}
        if mode == "pairs":
            pairs = []
            for i1 in proj.image_list:
                if not i1.match_list:
                    i1.load_matches()
            for i1 in proj.image_list:
                for other, ml in i1.match_list.items():
                    i2 = name_idx.get(other)
                    if i2 is not None and len(ml) and i1.name < other:
                        pairs.append((len(ml), i1, i2))
            pairs.sort(key=lambda r: r[0])
            self.items = [(i1, i2) for _, i1, i2 in pairs]
        else:
            from ..apps import cull as cull_mod

            matches = proj.load_matches_grouped()
            errors, index = cull_mod.compute_errors(
                proj, matches, device=checked(device, "the review"))
            sums = {}
            counts = {}
            for e, (mi, oi) in zip(errors, index):
                img = matches[mi][2 + oi][0]
                sums[img] = sums.get(img, 0.0) + float(e)
                counts[img] = counts.get(img, 0) + 1
            order = sorted(sums, key=lambda k: sums[k] / counts[k],
                           reverse=True)
            self.items = [(proj.image_list[k],
                           sums[k] / counts[k]) for k in order]

    def current(self):
        if self.idx >= len(self.items):
            return None
        return self.items[self.idx]

    def handle_key(self, key):
        """Returns True while the session continues."""
        if self.done:
            return False
        if key == "q":
            self.done = True
            return False
        if key == "d" and self.idx < len(self.items):
            self.dropped.append(self.items[self.idx])
        self.idx += 1
        if self.idx >= len(self.items):
            self.done = True
        return not self.done

    def apply(self):
        """Write the discard decisions into the .match files (both
        directions, like the reference's delete path). In by-image mode
        the port loads each partner image's matches before it empties the
        entry toward the dropped image; the reference writes the partner's
        unloaded list, which loses the partner's other pairs."""
        n = 0
        if self.mode == "pairs":
            for i1, i2 in self.dropped:
                n += len(i1.match_list.get(i2.name, []))
                i1.match_list[i2.name] = []
                i2.match_list[i1.name] = []
                i1.matches_clean = False
                i2.matches_clean = False
        else:
            name_idx = {im.name: im for im in self.proj.image_list}
            for im, _ in self.dropped:
                if not im.match_list:
                    im.load_matches()
                for other, ml in list(im.match_list.items()):
                    n += len(ml)
                    im.match_list[other] = []
                    o = name_idx.get(other)
                    if o is not None:
                        # the reference saves o's list without loading it,
                        # which empties o's every other pair; the port
                        # loads it first
                        if not o.match_list:
                            o.load_matches()
                        o.match_list[im.name] = []
                        o.matches_clean = False
                im.matches_clean = False
        for im in self.proj.image_list:
            if not im.matches_clean:
                im.save_matches()
        return n


def cmd_review(args, key_script=None, device="cuda"):
    """Interactive triage: shows each item, reads d/q/other keys. With
    key_script (tests / scripted culls), the same decisions run headless."""
    proj = _proj(args.project)
    sess = ReviewSession(proj, mode="images" if args.by_image else "pairs",
                         device=device)
    if not sess.items:
        log("nothing to review")
        return 0
    if key_script is not None:
        for k in key_script:
            if not sess.handle_key(k):
                break
    else:
        import matplotlib
        matplotlib.use("TkAgg" if os.environ.get("DISPLAY") else "Agg")
        import matplotlib.pyplot as plt

        import cv2

        fig, ax = plt.subplots(figsize=(12, 6))

        def show():
            cur = sess.current()
            ax.clear()
            if cur is None:
                plt.close(fig)
                return
            if sess.mode == "pairs":
                i1, i2 = cur
                img1 = cv2.imread(proj.image_path(i1))
                img2 = cv2.imread(proj.image_path(i2))
                h = max(img1.shape[0], img2.shape[0])
                canvas = np.zeros((h, img1.shape[1] + img2.shape[1], 3),
                                  np.uint8)
                canvas[:img1.shape[0], :img1.shape[1]] = img1
                canvas[:img2.shape[0], img1.shape[1]:] = img2
                i1.load_features()
                i2.load_features()
                off = img1.shape[1]
                pairs = i1.match_list.get(i2.name, [])
                for a, b in pairs[:: max(len(pairs) // 200, 1)]:
                    p1 = tuple(int(v) for v in i1.kp[a])
                    p2 = (int(i2.kp[b][0]) + off, int(i2.kp[b][1]))
                    cv2.line(canvas, p1, p2, (0, 255, 0), 1)
                ax.imshow(canvas[..., ::-1])
                ax.set_title(f"[{sess.idx + 1}/{len(sess.items)}] "
                             f"{i1.name} ↔ {i2.name}: {len(pairs)} matches "
                             "(d=discard, q=quit, other=keep)")
            else:
                im, mre = cur
                img = cv2.imread(proj.image_path(im))
                ax.imshow(img[..., ::-1])
                ax.set_title(f"[{sess.idx + 1}/{len(sess.items)}] {im.name}"
                             f" mre={mre:.2f}px (d=discard its matches, "
                             "q=quit)")
            fig.canvas.draw_idle()

        def on_key(ev):
            alive = sess.handle_key(ev.key)
            if alive:
                show()
            else:
                plt.close(fig)

        fig.canvas.mpl_connect("key_press_event", on_key)
        show()
        plt.show()
    n = sess.apply()
    log(f"review: discarded {len(sess.dropped)} items ({n} matches)")
    return 0


def build_parser():
    p = argparse.ArgumentParser(prog="imageanalysis-inspect")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("features")
    s.add_argument("project")
    s.add_argument("image")
    s.add_argument("--out")
    s.set_defaults(fn=cmd_features)
    s = sub.add_parser("pair")
    s.add_argument("project")
    s.add_argument("image1")
    s.add_argument("image2")
    s.add_argument("--out")
    s.set_defaults(fn=cmd_pair)
    s = sub.add_parser("groups")
    s.add_argument("project")
    s.set_defaults(fn=cmd_groups)
    s = sub.add_parser("matches")
    s.add_argument("project")
    s.set_defaults(fn=cmd_matches)
    s = sub.add_parser("review", help="keyboard match triage "
                       "(3e-review-matches / 4b-mre-by-image interactive)")
    s.add_argument("project")
    s.add_argument("--by-image", action="store_true",
                   help="review images worst-mean-reprojection-first "
                        "instead of weakest pairs")
    s.add_argument("--keys", help="scripted key sequence (headless), e.g. "
                                  "'ddkq'")
    s.set_defaults(fn=lambda a, device: cmd_review(
        a, key_script=list(a.keys) if a.keys else None, device=device))
    return p


def main(argv=None, device="cuda"):
    """The command line's entry point, on device (IMGTPU_PLATFORM in the
    environment overrides it, as in apps/process.py)."""
    args = build_parser().parse_args(argv)
    dev = main_device(device)
    if args.cmd == "review":
        return args.fn(args, dev)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
